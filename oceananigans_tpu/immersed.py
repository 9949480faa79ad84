"""Immersed boundaries: masked topography on any underlying grid.

Reference layer: ``src/ImmersedBoundaries/`` (SURVEY.md §2.7) —
``ImmersedBoundaryGrid`` (``immersed_boundary_grid.jl:8-14``),
``GridFittedBottom`` (``grid_fitted_bottom.jl:21``), ``GridFittedBoundary``
(``grid_fitted_boundary.jl:9``), ``PartialCellBottom``
(``partial_cell_bottom.jl:11``), ``mask_immersed_field!``
(``mask_immersed_field.jl``).

Design: dense boolean masks + ``where`` instead of the
reference's active-cells gather maps (``active_cells_map.jl:13-30``) — whole-array
masked compute fuses where gather/scatter does not, and for ocean
domains (mostly-fluid) the masked FLOPs are cheaper than the data movement
a packed index list would cost. Solid faces carry zero velocity; tendencies
are masked; the pressure Poisson problem becomes the masked 7-point
operator solved by FFT-preconditioned CG (reference
``conjugate_gradient_poisson_solver.jl:9``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu.grids.base import AbstractGrid, Center, Face
from oceananigans_tpu.ops.operators import dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, shift

__all__ = ["ImmersedBoundaryGrid", "GridFittedBottom", "GridFittedBoundary",
           "PartialCellBottom", "mask_immersed_field", "solid_mask_at",
           "mask_flux", "ImmersedPoissonSolver", "masked_laplacian",
           "ImmersedBoundaryCondition", "immersed_flux_divergence",
           "regularize_immersed_bc", "scalar_diffusivity_of"]

X, Y, Z = 0, 1, 2


class GridFittedBottom:
    """Solid below z = bottom_height(x, y) (reference
    ``grid_fitted_bottom.jl:21``)."""

    def __init__(self, bottom_height):
        self.bottom_height = bottom_height

    def solid_ccc(self, grid):
        zc = jnp.broadcast_to(grid.zC, grid.shape)
        return zc < self._bottom_full(grid)

    def _bottom_full(self, grid):
        """Bottom height on the full (halo-extended) horizontal plane.
        Array-valued bottoms get their halos filled with the grid's real
        topology rules (periodic wrap / wall extrapolation), matching the
        reference's ``fill_halo_regions!(bottom_field)``
        (``grid_fitted_bottom.jl`` materialize_immersed_boundary)."""
        if callable(self.bottom_height):
            return self.bottom_height(grid.xC, grid.yC)
        h = jnp.asarray(self.bottom_height)
        if h.ndim != 2:
            return h
        from oceananigans_tpu.boundary_conditions import (
            fill_halo_regions, regularize_field_boundary_conditions,
        )
        from oceananigans_tpu.fields import LOC_C
        sx, sy, _ = grid.interior_slices
        full = jnp.zeros((grid.shape[0], grid.shape[1], 1), h.dtype)
        full = full.at[sx, sy, :].set(h.reshape(h.shape[0], h.shape[1], 1))
        bcs = regularize_field_boundary_conditions(None, grid, LOC_C)
        X, Y = 0, 1
        from oceananigans_tpu.boundary_conditions import _fill_axis
        from oceananigans_tpu.grids.base import Center as _C
        for axis in (X, Y):
            lbc, rbc = bcs.sides(axis)
            full = _fill_axis(full, grid, axis, _C, lbc, rbc, None, None)
        return full

    def __repr__(self):
        return f"GridFittedBottom({self.bottom_height!r})"


class PartialCellBottom(GridFittedBottom):
    """Bottom-fitted with partial cell heights (reference
    ``partial_cell_bottom.jl:11``): a cell is solid only when the bottom
    covers more than (1 − ε_min) of it; the bottom-adjacent fluid cell's
    height shrinks to the actual water fraction (``dz_fraction``)."""

    def __init__(self, bottom_height, minimum_fractional_cell_height=0.2):
        super().__init__(bottom_height)
        self.minimum_fractional_cell_height = float(
            minimum_fractional_cell_height)

    def solid_ccc(self, grid):
        # solid when the water fraction is below the minimum
        frac = self._water_fraction(grid)
        return frac < self.minimum_fractional_cell_height

    def _bottom(self, grid):
        return self._bottom_full(grid)

    def _water_fraction(self, grid):
        """Fraction of each cell above the bottom, in [0, 1]."""
        zf = jnp.broadcast_to(grid.zF, grid.shape)
        dz = jnp.broadcast_to(grid.dz(Center), grid.shape)
        h = self._bottom(grid)
        z_top = zf + dz        # top face of each cell (zF is bottom face)
        return jnp.clip((z_top - h) / dz, 0.0, 1.0)

    def dz_fraction(self, grid, solid):
        frac = self._water_fraction(grid)
        frac = jnp.clip(frac, self.minimum_fractional_cell_height, 1.0)
        return jnp.where(solid, 1.0, frac)


class GridFittedBoundary:
    """Arbitrary 3-D solid mask (reference ``grid_fitted_boundary.jl:9``)."""

    def __init__(self, mask):
        self.mask = mask

    def solid_ccc(self, grid):
        if callable(self.mask):
            x = jnp.broadcast_to(grid.xC, grid.shape)
            y = jnp.broadcast_to(grid.yC, grid.shape)
            z = jnp.broadcast_to(grid.zC, grid.shape)
            return jnp.asarray(self.mask(x, y, z), bool)
        m = jnp.asarray(self.mask, bool)
        if m.shape == tuple(grid.N):
            full = jnp.zeros(grid.shape, bool)
            sx, sy, sz = grid.interior_slices
            return full.at[sx, sy, sz].set(m)
        return m

    def __repr__(self):
        return "GridFittedBoundary(...)"


class ImmersedBoundaryGrid(AbstractGrid):
    """Wraps an underlying grid with solid/fluid masks at every staggered
    location (reference ``immersed_boundary_grid.jl:8-14``).

    Metric queries delegate to the underlying grid; masks are plain bool
    arrays registered as pytree data. With a :class:`PartialCellBottom`
    the bottom-adjacent cell heights shrink to the actual water-column
    fraction (reference ``partial_cell_bottom.jl:11``), so gentle slopes
    are represented without staircase error.
    """

    def __init__(self, underlying_grid, immersed_boundary):
        from oceananigans_tpu.boundary_conditions import fill_halo_regions
        g = underlying_grid
        solid = immersed_boundary.solid_ccc(g)
        # the mask must be HALO-CONSISTENT (periodic images identical at
        # the seams, mirrors at walls) or the masked Poisson operator loses
        # symmetry across periodic boundaries; fill with the default
        # center-located halo rules and re-threshold
        solid = fill_halo_regions(solid.astype(g.xC.dtype), g) > 0.5
        s = object.__setattr__
        s(self, "underlying_grid", g)
        s(self, "immersed_boundary", immersed_boundary)
        s(self, "solid_c", solid)
        # a velocity face is solid if EITHER adjacent cell is solid
        s(self, "solid_u", solid | shift(solid, -1, X))
        s(self, "solid_v", solid | shift(solid, -1, Y))
        s(self, "solid_w", solid | shift(solid, -1, Z))
        # partial-cell dz scaling σ(x,y,z) ∈ [ε, 1] for PartialCellBottom
        if isinstance(immersed_boundary, PartialCellBottom):
            sigma = immersed_boundary.dz_fraction(g, solid)
            s(self, "dz_sigma", fill_halo_regions(sigma, g))
        else:
            s(self, "dz_sigma", None)

    # ---- partial-cell-aware vertical metrics -----------------------------
    def dz(self, lz=Center):
        base = self.underlying_grid.dz(lz)
        if self.dz_sigma is None:
            return base
        if lz == Center:
            return self.dz_sigma * base
        # face spacing = center-to-center distance: average of the two
        # adjacent (scaled) half-cells
        dzc = self.dz_sigma * self.underlying_grid.dz(Center)
        return 0.5 * (dzc + shift(dzc, -1, Z))

    # ---- delegation ------------------------------------------------------
    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "underlying_grid"),
                       name)

    def dx(self, *a, **k):
        return self.underlying_grid.dx(*a, **k)

    def dy(self, *a, **k):
        return self.underlying_grid.dy(*a, **k)

    def Az(self, *a, **k):
        return self.underlying_grid.Az(*a, **k)

    @property
    def shape(self):
        return self.underlying_grid.shape

    @property
    def N(self):
        return self.underlying_grid.N

    @property
    def H(self):
        return self.underlying_grid.H

    @property
    def interior_slices(self):
        return self.underlying_grid.interior_slices

    def axis_topo(self, axis):
        return self.underlying_grid.axis_topo(axis)

    def mask_for(self, loc):
        """Solid mask at a staggered location tuple."""
        if loc[0] == Face:
            return self.solid_u
        if loc[1] == Face:
            return self.solid_v
        if loc[2] == Face:
            return self.solid_w
        return self.solid_c

    @property
    def fluid_fraction(self):
        sx, sy, sz = self.interior_slices
        sc = self.solid_c[sx, sy, sz]
        return 1.0 - jnp.mean(sc.astype(jnp.float32))

    def __repr__(self):
        return (f"ImmersedBoundaryGrid({self.underlying_grid!r}, "
                f"{self.immersed_boundary!r})")


def _ibg_flatten(g):
    leaves = [g.underlying_grid, g.solid_c, g.solid_u, g.solid_v, g.solid_w]
    has_sigma = g.dz_sigma is not None
    if has_sigma:
        leaves.append(g.dz_sigma)
    return tuple(leaves), (type(g.immersed_boundary).__name__, has_sigma)


def _ibg_unflatten(aux, children):
    name, has_sigma = aux
    obj = object.__new__(ImmersedBoundaryGrid)
    s = object.__setattr__
    s(obj, "underlying_grid", children[0])
    s(obj, "immersed_boundary", name)
    s(obj, "solid_c", children[1])
    s(obj, "solid_u", children[2])
    s(obj, "solid_v", children[3])
    s(obj, "solid_w", children[4])
    s(obj, "dz_sigma", children[5] if has_sigma else None)
    return obj


jax.tree_util.register_pytree_node(ImmersedBoundaryGrid, _ibg_flatten,
                                   _ibg_unflatten)


def mask_immersed_field(grid, a, loc, value=0.0):
    """Zero (or set) the solid-region values of a field (reference
    ``mask_immersed_field!``)."""
    solid = getattr(grid, "mask_for", None)
    if solid is None:
        return a
    return jnp.where(grid.mask_for(loc), value, a)


def solid_mask_at(grid, loc):
    """Solid mask at an arbitrary staggered location: a point is solid if
    ANY cell it touches is solid (the reference's ``inactive_node``,
    ``immersed_grid_metrics.jl`` / ``ImmersedBoundaries.jl:inactive_node``).
    Returns ``None`` on non-immersed grids. Works through grid wrappers
    (``_ScaledZGrid``) via attribute delegation."""
    solid = getattr(grid, "solid_c", None)
    if solid is None:
        return None
    m = solid
    for axis, l in enumerate(loc):
        if l == Face:
            m = m | shift(m, -1, axis)
    return m


def mask_flux(grid, f, loc):
    """Zero a flux located at ``loc`` wherever that location touches a
    solid cell — the whole-array form of the reference's conditional
    fluxes (``immersed_boundary_condition.jl`` ``conditional_flux_*``:
    zero flux through and inside the immersed boundary, i.e. free-slip /
    no-flux by default)."""
    m = solid_mask_at(grid, loc)
    if m is None or not hasattr(f, "ndim"):
        return f
    return jnp.where(m, 0.0, f)


# ---------------------------------------------------------------------------
# Masked Poisson operator + CG solver (reference
# conjugate_gradient_poisson_solver.jl)
# ---------------------------------------------------------------------------

def masked_laplacian(grid, p):
    """∇·(β∇p) with flux zeroed through solid faces: the discrete immersed
    pressure operator (negative semidefinite). Metrics come from the
    immersed grid itself so partial-cell dz scaling stays consistent with
    the divergence the model computes."""
    g = grid
    fluid_u = ~grid.solid_u
    fluid_v = ~grid.solid_v
    fluid_w = ~grid.solid_w
    gx = jnp.where(fluid_u, dx_f(p) / g.dx(Face, Center), 0.0) \
        * g.Ax(Face, Center, Center)
    gy = jnp.where(fluid_v, dy_f(p) / g.dy(Face, Center), 0.0) \
        * g.Ay(Center, Face, Center)
    gz = jnp.where(fluid_w, dz_f(p) / g.dz(Face), 0.0) * g.Az(Center, Center)
    lap = (dx_c(gx) + dy_c(gy) + dz_c(gz)) / g.V(Center, Center, Center)
    return jnp.where(grid.solid_c, 0.0, lap)


def masked_cg_solve(grid, rhs_interior, fill_halos, reduce_sum,
                    precond_apply, maxiter, reltol):
    """The masked-Poisson PCG shared by the serial
    :class:`ImmersedPoissonSolver` and the distributed
    ``DistributedImmersedPoissonSolver``: the two differ only in the
    injected halo fill (local vs ppermute exchange), the reduction
    (``jnp.sum`` vs psum-wrapped), and the preconditioner application
    (serial FFT solve vs pencil ``local_solve`` vs None → Jacobi)."""
    from oceananigans_tpu.fields import new_field
    from oceananigans_tpu.solvers.conjugate_gradient import (
        conjugate_gradient,
    )

    g = grid.underlying_grid
    sx, sy, sz = g.interior_slices

    # CG iterates live on interior fluid cells only: the halo region of
    # every operator output must be zeroed or the CG dot products pick
    # up halo garbage and the iteration diverges
    idx = np.zeros(g.shape, bool)
    idx[sx, sy, sz] = True
    fluid = jnp.logical_and(~grid.solid_c, idx)

    # CG needs a SYMMETRIC operator in the plain inner product. The
    # Laplacian L = V⁻¹·G (G = the flux-difference assembly) is only
    # symmetric when V is uniform; solve the volume-weighted system
    # G p = V·rhs instead, which is symmetric for any (partial-cell /
    # stretched) volumes.
    Vw = jnp.broadcast_to(grid.V(Center, Center, Center), g.shape)
    rhs = new_field(g, rhs_interior.dtype).at[sx, sy, sz].set(
        rhs_interior)
    b = jnp.where(fluid, rhs * Vw, 0.0)
    # compatibility: project out the nullspace (constants on fluid)
    nf = jnp.maximum(reduce_sum(fluid[sx, sy, sz]), 1)
    b_mean = reduce_sum(b[sx, sy, sz]) / nf
    b = jnp.where(fluid, b - b_mean, 0.0)

    def A(p):
        p = fill_halos(p)
        return jnp.where(fluid, Vw * masked_laplacian(grid, p), 0.0)

    if precond_apply is not None:
        def M(r):
            # FFT inverse of the uniform-volume operator: exact when V
            # is uniform (then G = V₀·L and M ∝ L⁻¹)
            pr = precond_apply(r[sx, sy, sz] / Vw[sx, sy, sz])
            out = jnp.zeros_like(r).at[sx, sy, sz].set(
                pr.astype(r.dtype))
            return jnp.where(fluid, out, 0.0)
    else:
        # Jacobi: diagonal of G (symmetric, handles partial cells)
        cx = jnp.where(~grid.solid_u,
                       grid.Ax(Face, Center, Center)
                       / g.dx(Face, Center), 0.0)
        cy = jnp.where(~grid.solid_v,
                       grid.Ay(Center, Face, Center)
                       / g.dy(Face, Center), 0.0)
        cz = jnp.where(~grid.solid_w,
                       grid.Az(Center, Center) / grid.dz(Face), 0.0)
        diag = -(cx + shift(cx, 1, X) + cy + shift(cy, 1, Y)
                 + cz + shift(cz, 1, Z))
        diag = jnp.where(fluid & (diag < 0), diag, -1.0)

        def M(r):
            return jnp.where(fluid, r / diag, 0.0)

    def dot(x, y):
        local = sum(jnp.sum(a * b2) for a, b2 in zip(
            jax.tree_util.tree_leaves(x), jax.tree_util.tree_leaves(y)))
        # reduce_sum of a scalar is the identity serially and the psum
        # under distribution
        return reduce_sum(local)

    x0 = jnp.zeros_like(b)
    p, _, _ = conjugate_gradient(A, b, x0, preconditioner=M,
                                 maxiter=maxiter, reltol=reltol, dot=dot)
    # gauge: zero fluid mean
    p_mean = reduce_sum(jnp.where(fluid, p, 0.0)[sx, sy, sz]) / nf
    p = jnp.where(fluid, p - p_mean, 0.0)
    return p[sx, sy, sz]


class ImmersedPoissonSolver:
    """FFT-preconditioned CG for the masked Poisson problem (reference
    ``conjugate_gradient_poisson_solver.jl:9``). Operates on interior-shaped
    RHS like the FFT solver; halos are refilled (periodic wrap / mirror)
    internally each operator application via roll semantics (the masked
    operator only reads one ring, and masks are halo-consistent)."""

    def __init__(self, grid, preconditioner=None, maxiter=None,
                 reltol=None):
        from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver
        self.grid = grid
        base = grid.underlying_grid
        # dtype-aware default: 1e-8 is unreachable in float32 (the CG
        # stalls at the precision floor; with the old unguarded
        # divisions it then produced NaN)
        if reltol is None:
            import numpy as _np
            from oceananigans_tpu.config import config as _cfg
            reltol = 1e-8 if _np.dtype(_cfg.float_dtype).itemsize >= 8 \
                else 2e-5
        self.reltol = reltol
        # the FFT preconditioner approximates the UNSCALED Laplacian; with
        # partial-cell dz scaling it is inconsistent with the operator and
        # CG diverges — run plain CG there (more iterations, still robust)
        scaled = getattr(grid, "dz_sigma", None) is not None
        if preconditioner is None and base.regular and not scaled:
            preconditioner = FFTPoissonSolver(base)
        self.preconditioner = preconditioner
        if maxiter is None:
            maxiter = 600 if self.preconditioner is None else 200
        self.maxiter = maxiter

    def solve(self, rhs_interior):
        from oceananigans_tpu.boundary_conditions import (
            fill_halo_regions, regularize_field_boundary_conditions,
        )
        from oceananigans_tpu.fields import LOC_C

        grid = self.grid
        g = grid.underlying_grid
        bcs = regularize_field_boundary_conditions(None, g, LOC_C)
        precond_apply = (None if self.preconditioner is None
                         else self.preconditioner.solve)
        return masked_cg_solve(
            grid, rhs_interior,
            fill_halos=lambda p: fill_halo_regions(p, g, bcs, LOC_C),
            reduce_sum=jnp.sum, precond_apply=precond_apply,
            maxiter=self.maxiter, reltol=self.reltol)


# ---------------------------------------------------------------------------
# ImmersedBoundaryCondition: per-interface BCs on the immersed boundary
# (reference ``immersed_boundary_condition.jl`` +
#  ``TurbulenceClosures/immersed_diffusive_fluxes.jl``)
# ---------------------------------------------------------------------------

class ImmersedBoundaryCondition:
    """Conditions on individual wet-cell/solid-cell interfaces
    ``west/east/south/north/bottom/top`` (reference
    ``immersed_boundary_condition.jl:44-58``). Each side takes a
    ``FluxBC``/``ValueBC``/``GradientBC`` (or ``None``); pass it as the
    ``immersed=`` member of a field's :class:`FieldBoundaryConditions`."""

    _sides = ("west", "east", "south", "north", "bottom", "top")

    def __init__(self, west=None, east=None, south=None, north=None,
                 bottom=None, top=None):
        self.west, self.east = west, east
        self.south, self.north = south, north
        self.bottom, self.top = bottom, top

    def __repr__(self):
        parts = [f"{s}={getattr(self, s)!r}" for s in self._sides
                 if getattr(self, s) is not None]
        return f"ImmersedBoundaryCondition({', '.join(parts)})"


def regularize_immersed_bc(bc, loc):
    """Expand a plain BC into a 6-sided :class:`ImmersedBoundaryCondition`
    and drop the sides normal to ``Face``-located axes (reference
    ``regularize_immersed_boundary_condition``,
    ``immersed_boundary_condition.jl:72-93``: a Face-located field lies ON
    the boundary in its normal direction, so it has no boundary-normal
    immersed interface)."""
    if bc is None:
        return None
    if not isinstance(bc, ImmersedBoundaryCondition):
        bc = ImmersedBoundaryCondition(*(bc,) * 6)
    sides = {}
    for i, s in enumerate(ImmersedBoundaryCondition._sides):
        axis = i // 2
        v = getattr(bc, s)
        sides[s] = None if loc[axis] == Face else v
    out = ImmersedBoundaryCondition(**sides)
    if all(getattr(out, s) is None for s in out._sides):
        return None
    return out


def _immersed_bc_value(bc, grid, loc, time):
    """Evaluate a side condition at the 3-D nodes of ``loc``: scalars and
    broadcastable arrays pass through; callables are continuous boundary
    functions ``f(x, y, z, t)`` (the reference regularizes immersed-side
    ``ContinuousBoundaryFunction``s with all three coordinates)."""
    cond = bc.condition
    if cond is None:
        return None
    if callable(cond):
        from oceananigans_tpu.fields import location_coords
        x, y, z = location_coords(grid, loc)
        return cond(x, y, z, 0.0 if time is None else time)
    return cond


def immersed_flux_divergence(grid, ibc, loc, c, kappa, time=None):
    """Tendency contribution of the immersed-interface fluxes of field
    ``c`` at ``loc`` (ADD to G; reference ``immersed_flux_divergence``,
    ``immersed_diffusive_fluxes.jl:189-214``, via the stated convention
    that positive fluxes increase boundary-adjacent cell values).

    A wet node has an immersed interface on a side iff its neighbor node
    (same location, shifted along the axis) is solid. Per side:

    - ``FluxBC(q)``: + A q / V   (inward-normal flux, both sides)
    - ``ValueBC(cb)``: + A κ 2 (cb - c) / (Δ V)  (one-sided gradient,
      ``right_gradient``/``left_gradient``, immersed_diffusive_fluxes.jl)
    - ``GradientBC(g)``: ∓ A κ g / V  (-κg through the face; sign from
      which side the solid is on)

    ``kappa`` is the scalar-diffusivity coefficient (ν for momentum, κ for
    the tracer); the reference likewise applies Value/Gradient immersed
    conditions only for ``AbstractScalarDiffusivity`` closures and falls
    back to zero flux otherwise."""
    from oceananigans_tpu.boundary_conditions import FLUX, GRADIENT, VALUE

    solid = solid_mask_at(grid, loc)
    if solid is None or ibc is None:
        return 0.0
    wet = ~solid
    V = grid.V(*loc)
    flip = [Center if l == Face else Face for l in loc]
    areas = (grid.Ax(flip[0], loc[1], loc[2]),
             grid.Ay(loc[0], flip[1], loc[2]),
             grid.Az(loc[0], loc[1]))
    spacings = (grid.dx(*loc[:2]), grid.dy(*loc[:2]), grid.dz(loc[2]))
    out = 0.0
    for i, side in enumerate(ImmersedBoundaryCondition._sides):
        bc = getattr(ibc, side)
        if bc is None:
            continue
        axis, right = i // 2, i % 2
        if grid.N[axis] == 1:
            continue
        mask = wet & shift(solid, 1 if right else -1, axis)
        A, d = areas[axis], spacings[axis]
        if bc.classification == FLUX:
            q = _immersed_bc_value(bc, grid, loc, time)
            if q is None:
                continue
            term = A * q / V
        elif bc.classification == VALUE:
            cb = _immersed_bc_value(bc, grid, loc, time)
            term = A * kappa * 2.0 * (cb - c) / (d * V)
        elif bc.classification == GRADIENT:
            gv = _immersed_bc_value(bc, grid, loc, time)
            term = (1.0 if right else -1.0) * A * kappa * gv / V
        else:
            raise ValueError(
                f"unsupported immersed boundary condition "
                f"{bc.classification!r} on side {side!r}")
        out = out + jnp.where(mask, term, 0.0)
    return out


def scalar_diffusivity_of(closure, tracer=None):
    """Constant ν (``tracer=None``) or κ(tracer) summed over the
    scalar-diffusivity members of ``closure`` — the coefficient the
    immersed Value/Gradient fluxes use. Non-scalar closures contribute
    zero (the reference's non-ASD fallback,
    ``immersed_diffusive_fluxes.jl:157``)."""
    if closure is None:
        return 0.0
    if isinstance(closure, (tuple, list)):
        return sum(scalar_diffusivity_of(cl, tracer) for cl in closure)
    from oceananigans_tpu.closures import ScalarDiffusivity, _kappa_for
    if not isinstance(closure, ScalarDiffusivity):
        return 0.0
    if tracer is None:
        return closure.nu
    return _kappa_for(closure.kappa, tracer)
