"""Advection schemes: reconstruction + flux-form divergences.

Reference layer: ``src/Advection/`` (SURVEY.md §2.8) — centered
reconstruction (``centered_reconstruction.jl``), odd-order upwind
(``upwind_biased_reconstruction.jl``), WENO-Z
(``weno_reconstruction.jl:7``, ``weno_interpolants.jl``), flux assemblies
(``momentum_advection_operators.jl``, ``tracer_advection_operators.jl``),
per-direction composition (``flux_form_advection.jl``), CFL timescale
(``cell_advection_timescale.jl``).

Design: each reconstruction is a whole-array expression over
shifted copies of the operand; XLA fuses the stencil + smoothness indicators
+ nonlinear weights into one loop, so WENO's high arithmetic intensity
(~100 flops/point at order 5) runs out of registers, not device memory. There are
no data-dependent branches: upwinding is a ``where`` on the advecting
velocity sign, which vectorizes.

Index convention (see ops/operators.py): ``shift(a, n, axis)[i] = a[i+n]``.
A reconstruction "landing on faces" produces the value at face ``i`` (the
face between centers ``i-1`` and ``i``); "landing on centers" produces the
value at center ``i`` (between faces ``i`` and ``i+1``), which is the same
stencil shifted by +1. Left-biased stencils weight cells below the target
(upwind for positive velocity); right-biased are the mirror image.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from oceananigans_tpu.grids.base import Center, Face
from oceananigans_tpu.ops.operators import (
    dx_c, dx_f, dy_c, dy_f, dz_c, dz_f,
    ix_c, ix_f, iy_c, iy_f, iz_c, iz_f, shift,
)

__all__ = [
    "Centered", "UpwindBiased", "WENO", "FluxFormAdvection",
    "BoundPreserving",
    "div_Uc", "div_vu", "div_vv", "div_vw",
    "cell_advection_timescale", "required_halo", "adapt_advection_order",
]

X, Y, Z = 0, 1, 2


# ---------------------------------------------------------------------------
# Reconstruction stencils.
#
# Each entry maps an offset n -> coefficient of shift(a, n + o, axis) where
# o = 0 lands on faces and o = 1 lands on centers. Offsets are relative to
# the target face i: n = -1 is the first cell below the face, n = 0 the
# first above.
# ---------------------------------------------------------------------------

def _mirror(stencil):
    """Right-biased mirror: reflect offsets about the target face
    (cell ``n`` below the face <-> cell ``n`` above: n -> -1 - n)."""
    return {-1 - n: c for n, c in stencil.items()}


def _apply_stencil(a, axis, stencil, o):
    out = None
    for n, c in sorted(stencil.items()):
        term = c * shift(a, n + o, axis)
        out = term if out is None else out + term
    return out


def _bcast_table(c, axis):
    """(n,) numpy coefficient array -> broadcastable (.,1,1) form."""
    shape = [1, 1, 1]
    shape[axis] = len(c)
    return c.reshape(shape)


def _apply_stencil_tables(a, axis, tables, o):
    """Per-point (stretched-grid) stencil: coefficients are arrays
    along ``axis``. Only the o == 0 (cell-average -> face) target is
    tabulated; callers fall back to uniform coefficients otherwise."""
    out = None
    for n, c in sorted(tables.items()):
        term = c * shift(a, n + o, axis)
        out = term if out is None else out + term
    return out


def _stretched_axes(grid):
    """Axes that are non-regular (per-axis ``*_regular`` flags) with
    more than one cell AND a separable 1-D coordinate (curvilinear
    grids with 2-D coordinate fields keep uniform coefficients)."""
    axes = []
    for axis, flag in enumerate(("x_regular", "y_regular", "z_regular")):
        if grid.N[axis] <= 1 or getattr(grid, flag, True):
            continue
        name = ("x", "y", "z")[axis]
        coord = getattr(grid, f"{name}F", None)
        if coord is None or np.size(coord) != np.shape(coord)[axis]:
            continue
        axes.append(axis)
    return axes


def _cell_edges(grid, axis, o=0):
    """Halo-extended source-cell edge coordinates along ``axis``:
    o = 0 — CENTER-located data (edge i = face i);
    o = 1 — FACE-located data reconstructed to centers (the dual cells
    [xC[i-1], xC[i]]; the generator's index alignment matches the +1
    tap shift the o=1 application applies). Length n_total + 1."""
    name = ("x", "y", "z")[axis]
    arr = getattr(grid, f"{name}F" if o == 0 else f"{name}C")
    c = np.asarray(arr).reshape(-1)
    return np.append(c, 2 * c[-1] - c[-2])


# WENO sub-stencil reconstruction coefficients and ideal weights, left-biased
# at face i. Sub-stencil r uses cells i-1-r .. i-1-r+(k-1) for order 2k-1.
_WENO_GAMMA = {
    3: (1 / 3, 2 / 3),
    5: (1 / 10, 6 / 10, 3 / 10),
    7: (1 / 35, 12 / 35, 18 / 35, 4 / 35),
}

_WENO_Q = {
    3: ({-2: -1 / 2, -1: 3 / 2},
        {-1: 1 / 2, 0: 1 / 2}),
    5: ({-3: 2 / 6, -2: -7 / 6, -1: 11 / 6},
        {-2: -1 / 6, -1: 5 / 6, 0: 2 / 6},
        {-1: 2 / 6, 0: 5 / 6, 1: -1 / 6}),
    7: ({-4: -3 / 12, -3: 13 / 12, -2: -23 / 12, -1: 25 / 12},
        {-3: 1 / 12, -2: -5 / 12, -1: 13 / 12, 0: 3 / 12},
        {-2: -1 / 12, -1: 7 / 12, 0: 7 / 12, 1: -1 / 12},
        {-1: 3 / 12, 0: 13 / 12, 1: -5 / 12, 2: 1 / 12}),
}


def _weno3_betas(s):
    return ((s[-1] - s[-2]) ** 2,
            (s[0] - s[-1]) ** 2)


def _weno5_betas(s):
    c1, c2 = 13.0 / 12.0, 0.25
    b0 = (c1 * (s[-3] - 2 * s[-2] + s[-1]) ** 2
          + c2 * (s[-3] - 4 * s[-2] + 3 * s[-1]) ** 2)
    b1 = (c1 * (s[-2] - 2 * s[-1] + s[0]) ** 2
          + c2 * (s[-2] - s[0]) ** 2)
    b2 = (c1 * (s[-1] - 2 * s[0] + s[1]) ** 2
          + c2 * (3 * s[-1] - 4 * s[0] + s[1]) ** 2)
    return b0, b1, b2


def _weno7_betas(s):
    # Balsara & Shu (2000) smoothness indicators for k = 4. Edge and inner
    # sub-stencils have distinct quadratic forms; the two inner (and two
    # edge) forms are mirror images of each other.
    def beta_edge(a, b, c, d):
        # most-upwind stencil, target face adjacent to d
        return (a * (547 * a - 3882 * b + 4642 * c - 1854 * d)
                + b * (7043 * b - 17246 * c + 7042 * d)
                + c * (11003 * c - 9402 * d)
                + d * 2107 * d)

    def beta_inner(a, b, c, d):
        # stencil with one point downwind of the target face (face between
        # c and d)
        return (a * (267 * a - 1642 * b + 1602 * c - 494 * d)
                + b * (2843 * b - 5966 * c + 1922 * d)
                + c * (3443 * c - 2522 * d)
                + d * 547 * d)

    b0 = beta_edge(s[-4], s[-3], s[-2], s[-1])
    b1 = beta_inner(s[-3], s[-2], s[-1], s[0])
    b2 = beta_inner(s[1], s[0], s[-1], s[-2])   # mirror of the inner form
    b3 = beta_edge(s[2], s[1], s[0], s[-1])     # mirror of the edge form
    return b0, b1, b2, b3


_WENO_BETAS = {3: _weno3_betas, 5: _weno5_betas, 7: _weno7_betas}


# ---------------------------------------------------------------------------
# Scheme objects. Static config (hashable; braided into the jit trace).
# ---------------------------------------------------------------------------

class AdvectionScheme:
    """Base: a reconstruction rule. ``symmetric`` schemes provide
    ``reconstruct``; biased schemes provide ``biased`` and are combined with
    the advecting-velocity sign by the flux assemblies below."""

    symmetric = False
    order: int = 2

    @property
    def required_halo(self):
        # buffer size B for order p: centered p=2B, upwind/WENO p=2B-1
        # (reference ``Advection.jl:49-57`` boundary_buffer).
        return (self.order + 1) // 2

    def __eq__(self, other):
        return type(self) is type(other) and self.order == other.order

    def __hash__(self):
        return hash((type(self).__name__, self.order))


class Centered(AdvectionScheme):
    """Even-order centered reconstruction (reference
    ``centered_reconstruction.jl``; orders 2-12, generated exactly)."""

    symmetric = True

    def __init__(self, order: int = 2):
        if order % 2 or not 2 <= order <= 12:
            raise ValueError(f"Centered order must be even in 2..12, "
                             f"got {order}")
        self.order = order
        from oceananigans_tpu.ops.reconstruction_coefficients import (
            face_reconstruction_coefficients,
        )
        self._stencil = face_reconstruction_coefficients(order, "centered")

    def reconstruct(self, a, axis, o):
        tables = getattr(self, "_tables", None)
        if tables and (axis, o) in tables:
            return _apply_stencil_tables(a, axis, tables[(axis, o)], o)
        return _apply_stencil(a, axis, self._stencil, o)

    def bind_grid(self, grid):
        """Return a copy carrying per-point coefficient tables for the
        grid's stretched axes (reference: the stretched-grid coefficient
        branches of ``reconstruction_coefficients.jl``), for both the
        cell→face (o=0, tracers) and face→center (o=1, momentum)
        targets."""
        from oceananigans_tpu.ops.reconstruction_coefficients import (
            stretched_reconstruction_tables,
        )
        axes = _stretched_axes(grid)
        if not axes:
            return self
        new = Centered(self.order)
        new._tables = {}
        for axis in axes:
            for o in (0, 1):
                tab = stretched_reconstruction_tables(
                    _cell_edges(grid, axis, o), sorted(self._stencil))
                new._tables[(axis, o)] = {
                    off: _bcast_table(c, axis) for off, c in tab.items()}
        return new

    def __repr__(self):
        return f"Centered(order={self.order})"


class UpwindBiased(AdvectionScheme):
    """Odd-order upwind-biased reconstruction (reference
    ``upwind_biased_reconstruction.jl``; orders 1-11, generated exactly)."""

    def __init__(self, order: int = 3):
        if order % 2 == 0 or not 1 <= order <= 11:
            raise ValueError(f"UpwindBiased order must be odd in 1..11, "
                             f"got {order}")
        self.order = order
        from oceananigans_tpu.ops.reconstruction_coefficients import (
            face_reconstruction_coefficients,
        )
        self._left = face_reconstruction_coefficients(order, "left")

    def biased(self, a, axis, o):
        tables = getattr(self, "_tables", None)
        if tables and (axis, o) in tables:
            tl, tr = tables[(axis, o)]
            return (_apply_stencil_tables(a, axis, tl, o),
                    _apply_stencil_tables(a, axis, tr, o))
        left = _apply_stencil(a, axis, self._left, o)
        right = _apply_stencil(a, axis, _mirror(self._left), o)
        return left, right

    def bind_grid(self, grid):
        from oceananigans_tpu.ops.reconstruction_coefficients import (
            stretched_reconstruction_tables,
        )
        axes = _stretched_axes(grid)
        if not axes:
            return self
        new = UpwindBiased(self.order)
        new._tables = {}
        for axis in axes:
            for o in (0, 1):
                edges = _cell_edges(grid, axis, o)
                tl = stretched_reconstruction_tables(edges,
                                                     sorted(self._left))
                tr = stretched_reconstruction_tables(
                    edges, sorted(_mirror(self._left)))
                new._tables[(axis, o)] = (
                    {off: _bcast_table(c, axis)
                     for off, c in tl.items()},
                    {off: _bcast_table(c, axis)
                     for off, c in tr.items()})
        return new

    def __repr__(self):
        return f"UpwindBiased(order={self.order})"


class WENO(AdvectionScheme):
    """WENO-Z reconstruction (Borges et al. 2008), orders 3-11 (reference
    ``weno_reconstruction.jl:7``, ``weno_interpolants.jl``). Sub-stencil
    coefficients, ideal weights, and Jiang-Shu smoothness quadratic forms
    are generated exactly for every order
    (ops/reconstruction_coefficients.py); orders 3/5/7 keep the classic
    hand-derived indicator forms (cheaper: sums of few squares).

    All sub-stencil values, smoothness indicators, and nonlinear weights are
    branch-free array expressions; XLA fuses the whole thing into one pass.
    """

    def __init__(self, order: int = 5, epsilon: float = 1e-8, bounds=None):
        if order % 2 == 0 or not 3 <= order <= 11:
            raise ValueError(f"WENO order must be odd in 3..11, got {order}")
        self.order = order
        self.epsilon = epsilon
        # (lo, hi) tracer bounds: activates the positivity-preserving
        # limited flux divergence in div_Uc (reference PositiveWENO,
        # ``positivity_preserving_tracer_advection_operators.jl``)
        self.bounds = None if bounds is None else (float(bounds[0]),
                                                   float(bounds[1]))
        if order in _WENO_Q:
            self._qs = _WENO_Q[order]
            self._gammas = _WENO_GAMMA[order]
            self._beta_forms = None
        else:
            from oceananigans_tpu.ops.reconstruction_coefficients import (
                weno_beta_forms, weno_ideal_weights, weno_substencils,
            )
            self._qs = weno_substencils(order)
            self._gammas = weno_ideal_weights(order)
            self._beta_forms = weno_beta_forms(order)

    def _betas_from_forms(self, s):
        """β_r = sᵀ M_r s over the sub-stencil values (generated path)."""
        k = (self.order + 1) // 2
        betas = []
        for r, M in enumerate(self._beta_forms):
            offs = [(-1 - r) + j for j in range(k)]
            vals = [s[n] for n in offs]
            b = 0.0
            for m in range(k):
                b = b + M[m, m] * vals[m] * vals[m]
                for n in range(m + 1, k):
                    if abs(M[m, n]) > 1e-14:
                        b = b + 2.0 * M[m, n] * vals[m] * vals[n]
            betas.append(b)
        return tuple(betas)

    def _betas_of(self, s):
        if self._beta_forms is None:
            return _WENO_BETAS[self.order](s)
        return self._betas_from_forms(s)

    @staticmethod
    def _z_alphas(gammas, betas, eps):
        """WENO-Z unnormalized weights α_r = γ_r (1 + (τ/(β_r+ε))²) with a
        float32 overflow guard. When the smoothness field is dimensional
        (e.g. VelocityStencil / divergence-flux smoothness, where the
        field is δx(Ax u) ~ 1e7 so β ~ 1e14 while ε = 1e-8), the raw
        ratio reaches ~1e22; squaring overflows float32 to inf and the
        weight normalization returns inf/inf = NaN. Capping the ratio
        keeps every non-extreme weight bit-identical (the cap only
        engages when a stencil is already ~1e24× preferred); stencils
        past the cap share weight equally, which is physically the same
        'perfectly smooth' verdict. float64 uses a cap that is
        unreachable in practice, preserving reference parity."""
        tau = abs(betas[0] - betas[-1])
        cap = 1e12 if jnp.result_type(tau) == jnp.float32 else 1e60
        return [g * (1.0 + jnp.minimum(tau / (b + eps), cap) ** 2)
                for g, b in zip(gammas, betas)]

    def _onesided(self, shifts, axis, o, reflect, smooth_shifts=None):
        """``smooth_shifts``: optional list of shift-dicts of OTHER fields
        whose summed Jiang-Shu indicators replace ψ's own — the whole-array
        form of the reference's ``FunctionStencil``/``VelocityStencil``
        smoothness measures (``weno_interpolants.jl:350-362,548-556``:
        β from the smoothness field(s), sub-stencil values from ψ)."""
        order = self.order
        if reflect:
            s = {n: shifts[-1 - n] for n in shifts}
        else:
            s = shifts
        tables = getattr(self, "_tables", None)
        if tables and (axis, o) in tables:
            # stretched grid: per-point sub-stencil coefficients + ideal
            # weights; smoothness indicators keep the uniform forms (the
            # standard nonuniform-mesh practice)
            subs, gammas = tables[(axis, o)][1 if reflect else 0]
            qs = [_apply_stencil_shifted(shifts, sub) for sub in subs]
            if smooth_shifts is not None:
                betas = None
                for sm in smooth_shifts:
                    smr = ({n: sm[-1 - n] for n in sm} if reflect else sm)
                    bs = self._betas_of(smr)
                    betas = bs if betas is None else tuple(
                        b0 + b1 for b0, b1 in zip(betas, bs))
            else:
                betas = self._betas_of(s)
            eps = self.epsilon
            alphas = self._z_alphas(gammas, betas, eps)
            asum = alphas[0]
            for al in alphas[1:]:
                asum = asum + al
            out = alphas[0] * qs[0]
            for al, q in zip(alphas[1:], qs[1:]):
                out = out + al * q
            return out / asum
        qs = [_apply_stencil_shifted(s, q) for q in self._qs]
        if smooth_shifts is not None:
            betas = None
            for sm in smooth_shifts:
                smr = ({n: sm[-1 - n] for n in sm} if reflect else sm)
                bs = self._betas_of(smr)
                betas = bs if betas is None else tuple(
                    b0 + b1 for b0, b1 in zip(betas, bs))
        else:
            betas = self._betas_of(s)
        gammas = self._gammas
        eps = self.epsilon
        alphas = self._z_alphas(gammas, betas, eps)
        asum = alphas[0]
        for al in alphas[1:]:
            asum = asum + al
        out = alphas[0] * qs[0]
        for al, q in zip(alphas[1:], qs[1:]):
            out = out + al * q
        return out / asum

    def biased(self, a, axis, o, smooth=None):
        """``smooth``: optional list of arrays (same location as ``a``)
        whose summed smoothness indicators drive the nonlinear weights
        (FunctionStencil/VelocityStencil, see ``_onesided``)."""
        B = self.required_halo
        shifts = {n: shift(a, n + o, axis) for n in range(-B, B)}
        sm = None
        if smooth is not None:
            sm = [{n: shift(f, n + o, axis) for n in range(-B, B)}
                  for f in smooth]
        left = self._onesided(shifts, axis, o, reflect=False,
                              smooth_shifts=sm)
        right = self._onesided(shifts, axis, o, reflect=True,
                               smooth_shifts=sm)
        return left, right

    def bind_grid(self, grid):
        """Per-face sub-stencil coefficients + ideal weights for the
        grid's stretched axes (left AND right biased; the reflect trick
        is only valid on uniform spacings)."""
        from oceananigans_tpu.ops.reconstruction_coefficients import (
            weno_stretched_tables,
        )
        axes = _stretched_axes(grid)
        if not axes:
            return self
        k = (self.order + 1) // 2
        new = WENO(self.order, self.epsilon, bounds=self.bounds)
        new._tables = {}
        for axis in axes:
            for o in (0, 1):
                edges = _cell_edges(grid, axis, o)
                per_side = []
                for side in ("left", "right"):
                    subs_np, gam = weno_stretched_tables(
                        edges, self.order, side=side)
                    subs = [{off: _bcast_table(c, axis)
                             for off, c in t.items()} for t in subs_np]
                    gammas = [_bcast_table(gam[r].copy(), axis)
                              for r in range(k)]
                    per_side.append((subs, gammas))
                new._tables[(axis, o)] = tuple(per_side)
        return new

    def __eq__(self, other):
        return (type(self) is type(other) and self.order == other.order
                and self.epsilon == other.epsilon
                and self.bounds == other.bounds)

    def __hash__(self):
        return hash(("WENO", self.order, self.epsilon, self.bounds))

    def __repr__(self):
        if self.bounds is not None:
            return f"WENO(order={self.order}, bounds={self.bounds})"
        return f"WENO(order={self.order})"


def _apply_stencil_shifted(shifts, stencil):
    out = None
    for n, c in sorted(stencil.items()):
        term = c * shifts[n]
        out = term if out is None else out + term
    return out


class BoundPreserving(AdvectionScheme):
    """Bounds-limited wrapper: the underlying scheme's face
    reconstruction is clipped to the range of the two adjacent cell
    values, suppressing advective over/undershoots to the local-range
    level (reference ``positivity_preserving_tracer_advection_
    operators.jl`` capability, via local-bounds limiting rather than
    multidimensional FCT). Strict bound preservation additionally needs
    SSP time stepping; with the default (non-SSP) Wray RK3 small O(1e-5)
    excursions remain."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.order = scheme.order
        self.symmetric = scheme.symmetric

    def bind_grid(self, grid):
        b = getattr(self.scheme, "bind_grid", None)
        return BoundPreserving(b(grid)) if b else self

    @property
    def required_halo(self):
        return self.scheme.required_halo

    def _bounds(self, a, axis, o):
        lo_n = shift(a, o - 1, axis)    # cell below the target face
        hi_n = shift(a, o, axis)        # cell above
        return (jnp.minimum(lo_n, hi_n), jnp.maximum(lo_n, hi_n))

    def reconstruct(self, a, axis, o):
        lo, hi = self._bounds(a, axis, o)
        return jnp.clip(self.scheme.reconstruct(a, axis, o), lo, hi)

    def biased(self, a, axis, o):
        lo, hi = self._bounds(a, axis, o)
        left, right = self.scheme.biased(a, axis, o)
        return jnp.clip(left, lo, hi), jnp.clip(right, lo, hi)

    def __eq__(self, other):
        return type(self) is type(other) and self.scheme == other.scheme

    def __hash__(self):
        return hash(("BoundPreserving", self.scheme))

    def __repr__(self):
        return f"BoundPreserving({self.scheme!r})"


class FluxFormAdvection:
    """Per-direction scheme combination (reference
    ``flux_form_advection.jl``)."""

    def __init__(self, x, y=None, z=None):
        self.x = x
        self.y = x if y is None else y
        self.z = x if z is None else z

    def bind_grid(self, grid):
        def b(sc):
            f = getattr(sc, "bind_grid", None)
            return f(grid) if f else sc
        return FluxFormAdvection(b(self.x), b(self.y), b(self.z))

    @property
    def required_halo(self):
        return max(s.required_halo for s in (self.x, self.y, self.z))

    def scheme_for(self, axis):
        return (self.x, self.y, self.z)[axis]

    def __eq__(self, other):
        return (type(self) is type(other) and self.x == other.x
                and self.y == other.y and self.z == other.z)

    def __hash__(self):
        return hash((self.x, self.y, self.z))

    def __repr__(self):
        return f"FluxFormAdvection({self.x}, {self.y}, {self.z})"


def required_halo(scheme) -> int:
    if scheme is None:
        return 1
    return scheme.required_halo


def adapt_advection_order(scheme, grid):
    """Shrink the scheme order per axis so stencils fit small grids
    (reference ``adapt_advection_order.jl``; used
    ``nonhydrostatic_model.jl:175-178``). Returns the scheme unchanged when
    every axis fits, else a FluxFormAdvection of per-axis clamped orders."""
    if scheme is None or isinstance(scheme, FluxFormAdvection):
        return scheme

    def clamp(s, N):
        if N <= 1 or s.required_halo <= N:
            return s
        if isinstance(s, Centered):
            return Centered(max(2, 2 * N - (2 * N) % 2))
        order = max(1, min(s.order, 2 * N - 1))
        if order % 2 == 0:
            order -= 1
        if isinstance(s, WENO):
            return WENO(max(3, order), bounds=s.bounds) if order >= 3 \
                else UpwindBiased(1)
        return UpwindBiased(order)

    per_axis = [clamp(scheme, grid.N[ax]) for ax in range(3)]
    if all(p == scheme for p in per_axis):
        return scheme
    return FluxFormAdvection(*per_axis)


def _scheme_for(scheme, axis):
    if isinstance(scheme, FluxFormAdvection):
        return scheme.scheme_for(axis)
    return scheme


# ---------------------------------------------------------------------------
# Flux assembly
# ---------------------------------------------------------------------------

def _face_value(scheme, U, a, axis, o):
    """Reconstructed value of ``a`` at the flux location, upwinded on the
    sign of the (already interpolated) advecting velocity ``U``."""
    if scheme.symmetric:
        return scheme.reconstruct(a, axis, o)
    left, right = scheme.biased(a, axis, o)
    return jnp.where(U > 0, left, jnp.where(U < 0, right,
                                            0.5 * (left + right)))


def _face_value_smooth(scheme, U, a, axis, o, smooth=None):
    """Like ``_face_value`` but, for WENO schemes, measures smoothness on
    the ``smooth`` field(s) instead of ``a`` itself (the reference's
    FunctionStencil/VelocityStencil machinery)."""
    if getattr(scheme, "symmetric", False):
        return scheme.reconstruct(a, axis, o)
    if smooth is not None and isinstance(scheme, WENO):
        left, right = scheme.biased(a, axis, o, smooth=smooth)
    else:
        left, right = scheme.biased(a, axis, o)
    return jnp.where(U > 0, left, jnp.where(U < 0, right,
                                            0.5 * (left + right)))


def _near_boundary(a_solid, scheme, axis, o):
    """True where the scheme's full stencil touches a solid value of the
    reconstructed field (offsets [-R, R-1] for face targets, [-(R-1), R]
    for center targets, R = the scheme's buffer size)."""
    R = required_halo(scheme)
    lo, hi = (-R, R - 1) if o == 0 else (-(R - 1), R)
    near = None
    for n in range(lo, hi + 1):
        s = shift(a_solid, n, axis)
        near = s if near is None else (near | s)
    return near


def _face_value_ib(grid, scheme, U, a, axis, o, a_loc):
    """Immersed-aware reconstruction: where the full stencil touches a
    solid cell, fall back to the 2-point scheme, whose stencil reads only
    the two adjacent values and therefore never reads solid data at a wet
    flux point. Whole-array form of the reference's recursive
    ``buffer_scheme`` fallback (``immersed_advective_fluxes.jl:186-220``:
    ifelse(near_boundary, lower-order, full); this is a single-step
    cascade straight to the lowest order rather than one order at a
    time)."""
    from oceananigans_tpu.immersed import solid_mask_at
    fv = _face_value(scheme, U, a, axis, o)
    if required_halo(scheme) <= 1:
        return fv
    a_solid = solid_mask_at(grid, a_loc)
    if a_solid is None:
        return fv
    near = _near_boundary(a_solid, scheme, axis, o)
    fb = Centered(2) if getattr(scheme, "symmetric", False) \
        else UpwindBiased(1)
    return jnp.where(near, _face_value(fb, U, a, axis, o), fv)


# Zhang-Shu positivity limiter constants (reference
# ``positivity_preserving_tracer_advection_operators.jl:3-5``): ω̂₁ = ω̂ₙ =
# 5/18 are the endpoint weights of the 3-point Gauss-Lobatto quadrature
# through which the cell mean bounds the reconstruction polynomial.
_GL_W = 5.0 / 18.0
_GL_EPS = 1e-20


def _bounded_axis_flux(grid, scheme, U, c, axis, A):
    """Limited upwind tracer flux on ``axis`` faces: each cell's outgoing
    face reconstructions are scaled toward the cell mean by θ ∈ [0, 1] so
    the implied quadrature stays inside ``scheme.bounds`` (reference
    ``bounded_tracer_flux_divergence_x`` et al.; whole-array form)."""
    lo, hi = scheme.bounds
    left, right = scheme.biased(c, axis, 0)
    # cell i's reconstructions at its own faces: lower face (right-biased,
    # face i) and upper face (left-biased, face i+1)
    c_up_L = shift(left, 1, axis)
    c_lo_R = right
    p = (c - _GL_W * c_lo_R - _GL_W * c_up_L) / (1.0 - 2.0 * _GL_W)
    M = jnp.maximum(p, jnp.maximum(c_up_L, c_lo_R))
    m = jnp.minimum(p, jnp.minimum(c_up_L, c_lo_R))
    theta = jnp.minimum(jnp.minimum(
        jnp.abs((hi - c) / (M - c + _GL_EPS)),
        jnp.abs((lo - c) / (m - c + _GL_EPS))), jnp.asarray(1.0, c.dtype))
    # face i values: left from cell i-1 (its limited upper-face value),
    # right from cell i (its limited lower-face value)
    cm = shift(c, -1, axis)
    lim_left = shift(theta, -1, axis) * (left - cm) + cm
    lim_right = theta * (c_lo_R - c) + c
    face = jnp.where(U > 0, lim_left,
                     jnp.where(U < 0, lim_right,
                               0.5 * (lim_left + lim_right)))
    return A * U * face


def _bounded_div_Uc(grid, scheme, u, v, w, c):
    fx = _bounded_axis_flux(grid, scheme, u, c, X,
                            grid.Ax(Face, Center, Center))
    fy = _bounded_axis_flux(grid, scheme, v, c, Y,
                            grid.Ay(Center, Face, Center))
    fz = _bounded_axis_flux(grid, scheme, w, c, Z, grid.Az(Center, Center))
    return (dx_c(fx) + dy_c(fy) + dz_c(fz)) / grid.V(Center, Center, Center)


def div_Uc(grid, scheme, u, v, w, c):
    """Tracer advective flux divergence ∇·(𝐯c) at (c,c,c) (reference
    ``tracer_advection_operators.jl`` `div_Uc`)."""
    if scheme is None:
        return jnp.zeros_like(c)
    if getattr(scheme, "bounds", None) is not None:
        return _bounded_div_Uc(grid, scheme, u, v, w, c)
    sx, sy, sz = (_scheme_for(scheme, ax) for ax in range(3))
    LC = (Center, Center, Center)
    fx = grid.Ax(Face, Center, Center) * u * _face_value_ib(grid, sx, u, c,
                                                            X, 0, LC)
    fy = grid.Ay(Center, Face, Center) * v * _face_value_ib(grid, sy, v, c,
                                                            Y, 0, LC)
    fz = grid.Az(Center, Center) * w * _face_value_ib(grid, sz, w, c,
                                                      Z, 0, LC)
    return (dx_c(fx) + dy_c(fy) + dz_c(fz)) / grid.V(Center, Center, Center)


def div_vu(grid, scheme, u, v, w, uq=None):
    """Momentum advection ∇·(𝐯u) at u's location (f,c,c) (reference
    ``momentum_advection_operators.jl`` `div_𝐯u`). ``uq`` is the advected
    field (defaults to ``u``; differs for background-flow decompositions)."""
    if scheme is None:
        return jnp.zeros_like(u)
    uq = u if uq is None else uq
    sx, sy, sz = (_scheme_for(scheme, ax) for ax in range(3))
    LU = (Face, Center, Center)
    # x-flux at (c,c,c): ℑx_c(Ax u) advects u landing on centers (o=1)
    Uadv = ix_c(grid.Ax(Face, Center, Center) * u)
    fxx = Uadv * _face_value_ib(grid, sx, Uadv, uq, X, 1, LU)
    # y-flux at (f,f,c): ℑx_f(Ay v) advects u landing on y-faces (o=0)
    Vadv = ix_f(grid.Ay(Center, Face, Center) * v)
    fxy = Vadv * _face_value_ib(grid, sy, Vadv, uq, Y, 0, LU)
    # z-flux at (f,c,f): ℑx_f(Az w) advects u landing on z-faces (o=0)
    Wadv = ix_f(grid.Az(Center, Center) * w)
    fxz = Wadv * _face_value_ib(grid, sz, Wadv, uq, Z, 0, LU)
    # on immersed grids, zero the cross-term fluxes whose transverse
    # averaging leaks across the boundary (reference
    # ``immersed_advective_fluxes.jl`` conditional fluxes)
    from oceananigans_tpu.immersed import mask_flux
    fxy = mask_flux(grid, fxy, (Face, Face, Center))
    fxz = mask_flux(grid, fxz, (Face, Center, Face))
    return (dx_f(fxx) + dy_c(fxy) + dz_c(fxz)) / grid.V(Face, Center, Center)


def div_vv(grid, scheme, u, v, w, vq=None):
    """∇·(𝐯v) at v's location (c,f,c)."""
    if scheme is None:
        return jnp.zeros_like(v)
    vq = v if vq is None else vq
    sx, sy, sz = (_scheme_for(scheme, ax) for ax in range(3))
    LV = (Center, Face, Center)
    Uadv = iy_f(grid.Ax(Face, Center, Center) * u)
    fyx = Uadv * _face_value_ib(grid, sx, Uadv, vq, X, 0, LV)
    Vadv = iy_c(grid.Ay(Center, Face, Center) * v)
    fyy = Vadv * _face_value_ib(grid, sy, Vadv, vq, Y, 1, LV)
    Wadv = iy_f(grid.Az(Center, Center) * w)
    fyz = Wadv * _face_value_ib(grid, sz, Wadv, vq, Z, 0, LV)
    from oceananigans_tpu.immersed import mask_flux
    fyx = mask_flux(grid, fyx, (Face, Face, Center))
    fyz = mask_flux(grid, fyz, (Center, Face, Face))
    return (dx_c(fyx) + dy_f(fyy) + dz_c(fyz)) / grid.V(Center, Face, Center)


def div_vw(grid, scheme, u, v, w, wq=None):
    """∇·(𝐯w) at w's location (c,c,f)."""
    if scheme is None:
        return jnp.zeros_like(w)
    wq = w if wq is None else wq
    sx, sy, sz = (_scheme_for(scheme, ax) for ax in range(3))
    LW = (Center, Center, Face)
    Uadv = iz_f(grid.Ax(Face, Center, Center) * u)
    fzx = Uadv * _face_value_ib(grid, sx, Uadv, wq, X, 0, LW)
    Vadv = iz_f(grid.Ay(Center, Face, Center) * v)
    fzy = Vadv * _face_value_ib(grid, sy, Vadv, wq, Y, 0, LW)
    Wadv = iz_c(grid.Az(Center, Center) * w)
    fzz = Wadv * _face_value_ib(grid, sz, Wadv, wq, Z, 1, LW)
    from oceananigans_tpu.immersed import mask_flux
    fzx = mask_flux(grid, fzx, (Face, Center, Face))
    fzy = mask_flux(grid, fzy, (Center, Face, Face))
    return (dx_c(fzx) + dy_c(fzy) + dz_f(fzz)) / grid.V(Center, Center, Face)


# ---------------------------------------------------------------------------
# CFL timescale (reference ``cell_advection_timescale.jl``)
# ---------------------------------------------------------------------------

def cell_advection_timescale(grid, u, v, w):
    """min over the interior of (|u|/Δx + |v|/Δy + |w|/Δz)⁻¹."""
    sx, sy, sz = grid.interior_slices
    dx = jnp.broadcast_to(grid.dx(Face, Center), grid.shape)[sx, sy, sz]
    dy = jnp.broadcast_to(grid.dy(Face, Center), grid.shape)[sx, sy, sz]
    dz = jnp.broadcast_to(grid.dz(Face), grid.shape)[sx, sy, sz]
    rate = (jnp.abs(u[sx, sy, sz]) / dx
            + jnp.abs(v[sx, sy, sz]) / dy
            + jnp.abs(w[sx, sy, sz]) / dz)
    return 1.0 / jnp.maximum(jnp.max(rate), 1e-30)


# ---------------------------------------------------------------------------
# Multidimensional (2-D horizontal) reconstruction filter (reference
# ``src/Advection/multi_dimensional_reconstruction.jl``): a fifth-order
# centered-WENO filter applied TRANSVERSE to a 1-D reconstruction, making
# the vector-invariant interpolations effectively two-dimensional on
# curvilinear grids. The γ/a/σ tables are the published constants of the
# fifth-order centered WENO interpolant.
# ---------------------------------------------------------------------------

_S15 = float(np.sqrt(15.0))
_MD_G1 = ((1008 + 71 * _S15) / 5240, 408 / 655, (1008 - 71 * _S15) / 5240)
_MD_G3 = ((1008 - 71 * _S15) / 5240, 408 / 655, (1008 + 71 * _S15) / 5240)
_MD_SP, _MD_SM = 214 / 80, 67 / 40
_MD_G2P = (9 / 80 / _MD_SP, 49 / 20 / _MD_SP, 9 / 80 / _MD_SP)
_MD_G2M = (9 / 40 / _MD_SM, 49 / 40 / _MD_SM, 9 / 40 / _MD_SM)
_MD_A1 = (((2 - 3 * _S15) / 60, (-4 + 12 * _S15) / 60, (62 - 9 * _S15) / 60),
          ((2 + 3 * _S15) / 60, 56 / 60, (2 - 3 * _S15) / 60),
          ((62 + 9 * _S15) / 60, (-4 - 12 * _S15) / 60, (2 + 3 * _S15) / 60))
_MD_A2 = ((-1 / 24, 2 / 24, 23 / 24),
          (-1 / 24, 26 / 24, -1 / 24),
          (23 / 24, 2 / 24, -1 / 24))
_MD_A3 = (((2 + 3 * _S15) / 60, (-4 - 12 * _S15) / 60, (62 + 9 * _S15) / 60),
          ((2 - 3 * _S15) / 60, 56 / 60, (2 + 3 * _S15) / 60),
          ((62 - 9 * _S15) / 60, (-4 + 12 * _S15) / 60, (2 - 3 * _S15) / 60))
_MD_EPS = 1e-6


def multi_dimensional_filter(q, axis):
    """Fifth-order centered-WENO filter of ``q`` along ``axis`` (the
    transverse leg of the reference's
    ``multi_dimensional_reconstruction_x/y``). Preserves constants
    exactly; in smooth regions reproduces ``q`` to fifth order."""
    t = {n: shift(q, n, axis) for n in (-2, -1, 0, 1, 2)}
    S = ((t[-2], t[-1], t[0]), (t[-1], t[0], t[1]), (t[0], t[1], t[2]))

    def comb(A):
        return tuple(A[r][0] * S[r][0] + A[r][1] * S[r][1]
                     + A[r][2] * S[r][2] for r in range(3))

    q1h = comb(_MD_A1)
    q2h = comb(_MD_A2)
    q3h = comb(_MD_A3)

    c1, c2 = 13.0 / 12.0, 0.25
    b0 = (c1 * (S[0][0] - 2 * S[0][1] + S[0][2]) ** 2
          + c2 * (S[0][0] - 4 * S[0][1] + 3 * S[0][2]) ** 2)
    b1 = (c1 * (S[1][0] - 2 * S[1][1] + S[1][2]) ** 2
          + c2 * (S[1][0] - S[1][2]) ** 2)
    b2 = (c1 * (S[2][0] - 2 * S[2][1] + S[2][2]) ** 2
          + c2 * (3 * S[2][0] - 4 * S[2][1] + S[2][2]) ** 2)

    def weights(g):
        a0 = g[0] / (b0 + _MD_EPS) ** 2
        a1 = g[1] / (b1 + _MD_EPS) ** 2
        a2 = g[2] / (b2 + _MD_EPS) ** 2
        s = a0 + a1 + a2
        return a0 / s, a1 / s, a2 / s

    def total(g, qh):
        w0, w1, w2 = weights(g)
        return w0 * qh[0] + w1 * qh[1] + w2 * qh[2]

    q1 = total(_MD_G1, q1h)
    q3 = total(_MD_G3, q3h)
    q2 = _MD_SP * total(_MD_G2P, q2h) - _MD_SM * total(_MD_G2M, q2h)
    return q1 / 6 + 2 * q2 / 3 + q3 / 6
