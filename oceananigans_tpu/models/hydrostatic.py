"""HydrostaticFreeSurfaceModel: primitive equations with a free surface.

Reference: ``src/Models/HydrostaticFreeSurfaceModels/`` (SURVEY.md §2.14) —
struct ``hydrostatic_free_surface_model.jl:28-49``, tendencies
``hydrostatic_free_surface_tendency_kernel_functions.jl:29-110``, w from
continuity ``compute_w_from_continuity.jl``, free surfaces
``explicit_free_surface.jl:14`` / ``SplitExplicitFreeSurfaces/`` /
``implicit_free_surface.jl:12``, AB2 step
``hydrostatic_free_surface_ab2_step.jl:12-33``.

Design notes:
- Prognostic state: u, v, tracers, η. w is diagnosed from continuity by a
  z-``cumsum`` (a log-depth scan XLA lowers well) instead of a per-column
  loop kernel.
- The split-explicit barotropic substepping is ONE ``lax.scan`` over the
  substep weights inside the jitted step (the reference unrolls ~50 tiny
  GPU kernels and is latency-bound there; a scan of fused 2-D ops is the
  answer here, reference ``step_split_explicit_free_surface.jl:100-115``).
- The free-surface solver choice is static config; no data-dependent
  branching anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu import closures as closures_mod
from oceananigans_tpu.advection import (
    Centered, cell_advection_timescale, div_Uc, div_vu, div_vv,
    required_halo as advection_required_halo,
)
from oceananigans_tpu.boundary_conditions import (
    apply_flux_bcs, fill_halo_regions,
    regularize_field_boundary_conditions,
)
from oceananigans_tpu.buoyancy import g_Earth, regularize_buoyancy
from oceananigans_tpu.fields import (
    LOC_C, LOC_U, LOC_V, LOC_W, new_field, set_field,
)
from oceananigans_tpu.forcings import materialize_forcing
from oceananigans_tpu.grids.base import Center, Face
from oceananigans_tpu.models.nonhydrostatic import _ModelAux
from oceananigans_tpu.ops.operators import (
    div_xy_cc, dx_f, dy_f, dz_f, dx_c, dy_c, dz_c,
    ix_c, ix_f, iy_c, iy_f, iz_c, shift,
    vorticity_z_ff,
)
from oceananigans_tpu.platform import poisson_transform
from oceananigans_tpu.timesteppers import Clock, ab2_coefficients, tick

__all__ = ["HydrostaticFreeSurfaceModel", "HydrostaticState",
           "ExplicitFreeSurface", "SplitExplicitFreeSurface",
           "ImplicitFreeSurface", "VectorInvariant",
           "WENOVectorInvariant", "OnlySelfUpwinding",
           "CrossAndSelfUpwinding",
           "PrescribedVelocityFields", "ZCoordinate", "ZStar"]

X, Y, Z = 0, 1, 2


# ---------------------------------------------------------------------------
# Momentum advection schemes
# ---------------------------------------------------------------------------

class OnlySelfUpwinding:
    """Upwinding treatment of the VI divergence flux and KE gradient in
    which only the terms in the TRANSPORTING velocity are upwinded; the
    tangential (cross) terms use ``cross_scheme`` symmetrically
    (reference ``vector_invariant_upwinding.jl:30-61`` +
    ``vector_invariant_self_upwinding.jl``)."""

    def __init__(self, cross_scheme=None):
        if cross_scheme is None or not getattr(cross_scheme, "symmetric",
                                               False):
            # the reference extracts the centered advecting-velocity
            # counterpart from upwind cross schemes
            # (``extract_centered_scheme``)
            cross_scheme = Centered(2)
        self.cross_scheme = cross_scheme

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.cross_scheme == other.cross_scheme)

    def __hash__(self):
        return hash((type(self).__name__, self.cross_scheme))

    def __repr__(self):
        return f"{type(self).__name__}(cross_scheme={self.cross_scheme!r})"


class CrossAndSelfUpwinding(OnlySelfUpwinding):
    """Both the self and tangential contributions of the divergence flux
    are upwinded together as one reconstruction of δx(Ax u) + δy(Ay v);
    the KE gradient keeps self-only upwinding (reference
    ``vector_invariant_cross_upwinding.jl``)."""


class VectorInvariant:
    """Rotational-form momentum advection (reference
    ``vector_invariant_advection.jl``): 𝐯·∇u = ζ ẑ×u + ∇K + w ∂z u.

    Full reference option matrix
    (``vector_invariant_advection.jl:36-63``):

    - ``vorticity_scheme``: "enstrophy_conserving" (default; ℑy(ζ)·v̂ with
      the LENGTH-weighted transverse velocity v̂ = ℑxy(Δx v)/Δxᶠᶜᶜ),
      "energy_conserving" (ℑy(ζ·ℑx(Δx v))/Δxᶠᶜᶜ), or a biased scheme
      (``UpwindBiased``/``WENO``): ζ reconstructed transversely, biased
      on the sign of v̂ (``horizontal_advection_U``,
      ``vector_invariant_advection.jl:367-385``).
    - ``vorticity_stencil``: "velocity" (default; WENO smoothness
      measured on the tangential velocities ℑy(u), ℑx(v) — reference
      ``VelocityStencil``) or "default" (smoothness of ζ itself).
    - ``vertical_scheme``: "energy_conserving" (default; ℑz(ℑx(w)∂z u))
      or a biased scheme — the vertical term becomes flux-form
      δz(ℑx(Az w)·uᴿ) PLUS the upwinded horizontal divergence flux
      (``vertical_advection_U``, ``vector_invariant_advection.jl:324-338``).
    - ``divergence_scheme``: biased scheme for δx(Ax u) (defaults to
      ``vertical_scheme`` when that is a scheme).
    - ``kinetic_energy_gradient_scheme``: "energy_conserving" (∂x of the
      centered horizontal KE) or a biased scheme for the self
      KE-difference δx(u²/2) (defaults to ``divergence_scheme``).
    - ``upwinding``: ``OnlySelfUpwinding()`` (default) or
      ``CrossAndSelfUpwinding()``.
    """

    def __init__(self, vorticity_scheme="enstrophy_conserving",
                 vorticity_stencil="velocity",
                 vertical_scheme="energy_conserving",
                 divergence_scheme=None,
                 kinetic_energy_gradient_scheme=None,
                 upwinding=None, multi_dimensional_stencil=False):
        if isinstance(vorticity_scheme, str) and vorticity_scheme not in (
                "enstrophy_conserving", "energy_conserving"):
            raise ValueError(
                f"unknown vorticity_scheme {vorticity_scheme!r}")
        if vorticity_stencil not in ("velocity", "default"):
            raise ValueError(
                f"unknown vorticity_stencil {vorticity_stencil!r}")
        if isinstance(vertical_scheme, str) and \
                vertical_scheme != "energy_conserving":
            raise ValueError(
                f"unknown vertical_scheme {vertical_scheme!r}")
        self.vorticity_scheme = vorticity_scheme
        self.vorticity_stencil = vorticity_stencil
        self.vertical_scheme = vertical_scheme
        if divergence_scheme is None and \
                not isinstance(vertical_scheme, str):
            divergence_scheme = vertical_scheme
        self.divergence_scheme = divergence_scheme
        if kinetic_energy_gradient_scheme is None:
            kinetic_energy_gradient_scheme = (
                divergence_scheme if divergence_scheme is not None
                else "energy_conserving")
        self.kinetic_energy_gradient_scheme = kinetic_energy_gradient_scheme
        self.upwinding = upwinding if upwinding is not None \
            else OnlySelfUpwinding()
        #: apply the transverse fifth-order WENO filter to every scheme-
        #: based horizontal reconstruction (reference
        #: ``multi_dimensional_stencil = true``, a 2-D horizontal stencil
        #: for curvilinear grids)
        self.multi_dimensional_stencil = bool(multi_dimensional_stencil)

    @property
    def required_halo(self):
        h = 1
        for s in (self.vorticity_scheme, self.vertical_scheme,
                  self.divergence_scheme,
                  self.kinetic_energy_gradient_scheme):
            if s is not None and not isinstance(s, str):
                h = max(h, s.required_halo)
        # ζ itself consumes one halo on top of any upwinded stencil
        # (reference ``required_halo_size_x(::VectorInvariant)``,
        # vector_invariant_advection.jl:244-252)
        h = h + 1 if h > 1 else 2
        # the transverse 2-D filter adds +-2 taps
        if getattr(self, "multi_dimensional_stencil", False):
            h += 2
        return h

    def _key(self):
        return ("VectorInvariant", self.vorticity_scheme,
                self.vorticity_stencil, self.vertical_scheme,
                self.divergence_scheme,
                self.kinetic_energy_gradient_scheme, self.upwinding,
                getattr(self, "multi_dimensional_stencil", False))

    def _md(self, q, interp_axis):
        """Transverse 2-D filter of a horizontal reconstruction: an
        x-direction interpolation gets filtered along y and vice versa
        (reference ``_multi_dimensional_reconstruction_y/x`` wrapping of
        the VI interpolates). No-op unless ``multi_dimensional_stencil``."""
        if not getattr(self, "multi_dimensional_stencil", False):
            return q
        from oceananigans_tpu.advection import multi_dimensional_filter
        return multi_dimensional_filter(q, Y if interp_axis == X else X)

    def __eq__(self, other):
        return isinstance(other, VectorInvariant) and \
            self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"VectorInvariant({self.vorticity_scheme!r}, "
                f"vertical_scheme={self.vertical_scheme!r})")

    # -- vorticity term ---------------------------------------------------
    def _zeta_smooth(self, u, v):
        from oceananigans_tpu.advection import WENO
        if self.vorticity_stencil == "velocity" and \
                isinstance(self.vorticity_scheme, WENO):
            # tangential velocities at ζ's (f,f,·) location (reference
            # ``tangential_stencil_u/v``, weno_interpolants.jl:469-472)
            return [iy_f(u), ix_f(v)]
        return None

    def _zeta_v(self, grid, zeta, u, v):
        """+ζ-flux term of the u equation at (f,c,c)."""
        dxv = grid.dx(Center, Face) * v
        if self.vorticity_scheme == "energy_conserving":
            return iy_c(zeta * ix_f(dxv)) / grid.dx(Face, Center)
        if self.vorticity_scheme == "enstrophy_conserving":
            return iy_c(zeta) * ix_f(iy_c(dxv)) / grid.dx(Face, Center)
        from oceananigans_tpu.advection import _face_value_smooth
        vhat = self._md(ix_f(iy_c(dxv)) / grid.dx(Face, Center), X)
        # ζ is y-face-located: reconstruct to y-centers (o = 1)
        zr = self._md(_face_value_smooth(self.vorticity_scheme, vhat, zeta,
                                         Y, 1, self._zeta_smooth(u, v)), Y)
        return vhat * zr

    def _zeta_u(self, grid, zeta, u, v):
        dyu = grid.dy(Center, Face) * u
        if self.vorticity_scheme == "energy_conserving":
            return ix_c(zeta * iy_f(dyu)) / grid.dy(Face, Center)
        if self.vorticity_scheme == "enstrophy_conserving":
            return ix_c(zeta) * iy_f(ix_c(dyu)) / grid.dy(Face, Center)
        from oceananigans_tpu.advection import _face_value_smooth
        uhat = self._md(iy_f(ix_c(dyu)) / grid.dy(Face, Center), Y)
        zr = self._md(_face_value_smooth(self.vorticity_scheme, uhat, zeta,
                                         X, 1, self._zeta_smooth(u, v)), X)
        return uhat * zr

    # -- Bernoulli head ---------------------------------------------------
    def _bernoulli_u(self, grid, u, v):
        """∂x K at (f,c,c) (reference ``bernoulli_head_U``)."""
        ke = self.kinetic_energy_gradient_scheme
        if isinstance(ke, str):
            K = 0.5 * (ix_c(u * u) + iy_c(v * v))
            return dx_f(K) / grid.dx(Face, Center)
        from oceananigans_tpu.advection import WENO, _face_value_smooth
        du2 = dx_c(0.5 * u * u)          # δx(u²/2) at (c,c,c)
        dv2 = dx_f(0.5 * v * v)          # δx(v²/2) at (f,f,c)
        smooth = [ix_c(u)] if isinstance(ke, WENO) else None
        duR = self._md(_face_value_smooth(ke, u, du2, X, 0, smooth), X)
        dvS = self._md(self.upwinding.cross_scheme.reconstruct(dv2, Y, 1), Y)
        return (duR + dvS) / grid.dx(Face, Center)

    def _bernoulli_v(self, grid, u, v):
        ke = self.kinetic_energy_gradient_scheme
        if isinstance(ke, str):
            K = 0.5 * (ix_c(u * u) + iy_c(v * v))
            return dy_f(K) / grid.dy(Face, Center)
        from oceananigans_tpu.advection import WENO, _face_value_smooth
        dv2 = dy_c(0.5 * v * v)          # (c,c,c)
        du2 = dy_f(0.5 * u * u)          # (f,f,c)
        smooth = [iy_c(v)] if isinstance(ke, WENO) else None
        dvR = self._md(_face_value_smooth(ke, v, dv2, Y, 0, smooth), Y)
        duS = self._md(self.upwinding.cross_scheme.reconstruct(du2, X, 1), X)
        return (dvR + duS) / grid.dy(Face, Center)

    # -- vertical + divergence flux ---------------------------------------
    def _div_terms(self, grid, u, v):
        dxU = dx_c(grid.Ax(Face, Center, Center) * u)    # (c,c,c)
        dyV = dy_c(grid.Ay(Center, Face, Center) * v)    # (c,c,c)
        return dxU, dyV

    def _vertical_u(self, grid, u, v, w):
        """+[w ∂z u] term of 𝐯·∇u at (f,c,c) (reference
        ``vertical_advection_U``)."""
        vs = self.vertical_scheme
        if isinstance(vs, str):
            w_fcf = ix_f(w)
            dudz = dz_f(u) / grid.dz(Face)
            return iz_c(w_fcf * dudz)
        from oceananigans_tpu.advection import (
            WENO, _face_value, _face_value_smooth,
        )
        dxU, dyV = self._div_terms(grid, u, v)
        ds = self.divergence_scheme
        if isinstance(self.upwinding, CrossAndSelfUpwinding):
            dR = self._md(_face_value_smooth(ds, u, dxU + dyV, X, 0, None),
                          X)
            phi = u * dR
        else:
            smooth = [dxU + dyV] if isinstance(ds, WENO) else None
            duR = self._md(_face_value_smooth(ds, u, dxU, X, 0, smooth), X)
            dvS = self._md(
                self.upwinding.cross_scheme.reconstruct(dyV, X, 0), X)
            phi = u * (dvS + duR)
        Wadv = ix_f(grid.Az(Center, Center) * w)         # (f,c,f)
        uz = _face_value(vs, Wadv, u, Z, 0)
        return (phi + dz_c(Wadv * uz)) / grid.V(Face, Center, Center)

    def _vertical_v(self, grid, u, v, w):
        vs = self.vertical_scheme
        if isinstance(vs, str):
            w_cff = iy_f(w)
            dvdz = dz_f(v) / grid.dz(Face)
            return iz_c(w_cff * dvdz)
        from oceananigans_tpu.advection import (
            WENO, _face_value, _face_value_smooth,
        )
        dxU, dyV = self._div_terms(grid, u, v)
        ds = self.divergence_scheme
        if isinstance(self.upwinding, CrossAndSelfUpwinding):
            dR = self._md(_face_value_smooth(ds, v, dxU + dyV, Y, 0, None),
                          Y)
            phi = v * dR
        else:
            smooth = [dxU + dyV] if isinstance(ds, WENO) else None
            dvR = self._md(_face_value_smooth(ds, v, dyV, Y, 0, smooth), Y)
            duS = self._md(
                self.upwinding.cross_scheme.reconstruct(dxU, Y, 0), Y)
            phi = v * (duS + dvR)
        Wadv = iy_f(grid.Az(Center, Center) * w)         # (c,f,f)
        vz = _face_value(vs, Wadv, v, Z, 0)
        return (phi + dz_c(Wadv * vz)) / grid.V(Center, Face, Center)

    # -- tendencies -------------------------------------------------------
    def u_tendency(self, grid, u, v, w, zeta=None):
        """−[𝐯·∇u]ₓ at (f,c,c). ``zeta`` overrides the locally computed
        vorticity (the cubed sphere passes its corner-circulation-fixed
        ζ, ``cubed_sphere_corner_vorticity``)."""
        if zeta is None:
            zeta = vorticity_z_ff(grid, u, v)   # (f,f,c)
        return (self._zeta_v(grid, zeta, u, v)
                - self._bernoulli_u(grid, u, v)
                - self._vertical_u(grid, u, v, w))

    def v_tendency(self, grid, u, v, w, zeta=None):
        if zeta is None:
            zeta = vorticity_z_ff(grid, u, v)
        return (-self._zeta_u(grid, zeta, u, v)
                - self._bernoulli_v(grid, u, v)
                - self._vertical_v(grid, u, v, w))


class WENOVectorInvariant(VectorInvariant):
    """WENO vector-invariant convenience constructor (reference
    ``WENOVectorInvariant``, ``vector_invariant_advection.jl:193-238``):
    vorticity WENO(vorticity_order) with VelocityStencil smoothness,
    flux-form WENO vertical advection + upwinded divergence flux and KE
    gradient with ``OnlySelfUpwinding``. Reference defaults: vorticity
    order 9, all others 5."""

    def __init__(self, vorticity_order=None, order=None,
                 vertical_order=None, divergence_order=None,
                 kinetic_energy_gradient_order=None, upwinding=None,
                 vorticity_stencil="velocity",
                 multi_dimensional_stencil=False):
        from oceananigans_tpu.advection import WENO
        vorticity_order = vorticity_order or order or 9
        vertical_order = vertical_order or order or 5
        divergence_order = divergence_order or order or 5
        kinetic_energy_gradient_order = (kinetic_energy_gradient_order
                                         or order or 5)
        super().__init__(
            vorticity_scheme=WENO(vorticity_order),
            vorticity_stencil=vorticity_stencil,
            vertical_scheme=WENO(vertical_order),
            divergence_scheme=WENO(divergence_order),
            kinetic_energy_gradient_scheme=WENO(
                kinetic_energy_gradient_order),
            upwinding=upwinding,
            multi_dimensional_stencil=multi_dimensional_stencil)

    def __repr__(self):
        return (f"WENOVectorInvariant(vorticity_order="
                f"{self.vorticity_scheme.order}, vertical_order="
                f"{self.vertical_scheme.order})")


# ---------------------------------------------------------------------------
# Free surfaces
# ---------------------------------------------------------------------------

class ExplicitFreeSurface:
    """∂t η = −∇·U with g∇η explicit in the momentum tendency (reference
    ``explicit_free_surface.jl:14``). Gravity-wave CFL limits Δt."""

    def __init__(self, gravitational_acceleration=g_Earth):
        self.g = float(gravitational_acceleration)

    def __eq__(self, other):
        return type(self) is type(other) and self.g == other.g

    def __hash__(self):
        return hash(("ExplicitFS", self.g))

    def __repr__(self):
        return f"ExplicitFreeSurface(g={self.g:g})"


def averaging_shape_function(tau, p=2, q=4, r=0.18927):
    """Shchepetkin & McWilliams (2005) dispersion-minimizing barotropic
    averaging kernel (reference ``split_explicit_free_surface.jl:210-215``).
    """
    tau0 = (p + 2) * (p + q + 2) / (p + 1) / (p + q + 1)
    return (tau / tau0) ** p * (1 - (tau / tau0) ** q) - r * (tau / tau0)


def weights_from_substeps(substeps, kernel=averaging_shape_function):
    """Normalized averaging weights over τ ∈ (0, 2], truncated at the last
    positive weight (reference ``weights_from_substeps``,
    ``split_explicit_free_surface.jl:251-260``)."""
    tau_f = np.linspace(0.0, 2.0, substeps + 1)
    frac = tau_f[1] - tau_f[0]
    w = np.array([kernel(t) for t in tau_f[1:]])
    idx = len(w)
    while idx > 0 and w[idx - 1] <= 0:
        idx -= 1
    w = w[:idx]
    return frac, w / w.sum()


class SplitExplicitFreeSurface:
    """Barotropic substepping with filtered averaging (reference
    ``SplitExplicitFreeSurfaces/split_explicit_free_surface.jl:5-12``)."""

    def __init__(self, substeps=30, gravitational_acceleration=g_Earth,
                 averaging_kernel=averaging_shape_function):
        self.g = float(gravitational_acceleration)
        self.substeps = int(substeps)
        frac, w = weights_from_substeps(self.substeps, averaging_kernel)
        # python float, not np.float64: a numpy scalar would strongly
        # promote float32 state to float64 under jax_enable_x64
        self.fractional_step = float(frac)
        self.weights = tuple(float(x) for x in w)

    def __eq__(self, other):
        return (type(self) is type(other) and self.g == other.g
                and self.weights == other.weights)

    def __hash__(self):
        return hash(("SplitExplicitFS", self.g, self.weights))

    def __repr__(self):
        return (f"SplitExplicitFreeSurface(substeps={len(self.weights)}, "
                f"g={self.g:g})")


class ImplicitFreeSurface:
    """Backward-Euler barotropic step: solve the 2-D elliptic problem

        [∇·(gH∇) − 1/Δt²] η^{n+1} = RHS = (∇·U* − η^n/Δt)/Δt

    then correct u with −Δt g ∇η^{n+1} (reference
    ``implicit_free_surface.jl:12`` + ``fft_based_implicit_free_surface_
    solver.jl:12`` / ``pcg_implicit_free_surface_solver.jl:18``).

    ``solver_method``: "fft" (regular grids; eigenvalue division — the
    reference's FFTBasedImplicitFreeSurfaceSolver), "cg"
    (matrix-free preconditioned CG, any grid), or "matrix" (explicit
    pentadiagonal stencil matrix + Jacobi-PCG — the reference's
    MatrixImplicitFreeSurfaceSolver/HeptadiagonalIterativeSolver,
    ``matrix_implicit_free_surface_solver.jl:18``).
    """

    def __init__(self, gravitational_acceleration=g_Earth,
                 solver_method="fft", maxiter=200, reltol=1e-9,
                 preconditioner="jacobi"):
        """``preconditioner`` (matrix method): "jacobi" or "spai"/int —
        the Neumann-polynomial stencil approximate inverse (whole-array
        analog of the reference's SPAI option,
        ``sparse_approximate_inverse.jl``; see
        ``solvers/matrix_solver.py``)."""
        self.g = float(gravitational_acceleration)
        if solver_method not in ("fft", "cg", "matrix"):
            raise ValueError(f"unknown solver_method {solver_method!r} "
                             "(expected 'fft', 'cg', or 'matrix')")
        self.solver_method = solver_method
        self.maxiter = maxiter
        self.reltol = reltol
        self.preconditioner = preconditioner

    def __eq__(self, other):
        return (type(self) is type(other) and self.g == other.g
                and self.solver_method == other.solver_method
                and getattr(self, "preconditioner", "jacobi")
                == getattr(other, "preconditioner", "jacobi"))

    def __hash__(self):
        return hash(("ImplicitFS", self.g, self.solver_method,
                     str(self.preconditioner)))

    def __repr__(self):
        return (f"ImplicitFreeSurface(g={self.g:g}, "
                f"solver={self.solver_method})")


class ZCoordinate:
    """Static vertical coordinate (default)."""

    def __repr__(self):
        return "ZCoordinate()"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash("ZCoordinate")


class ZStar:
    """Free-surface-following vertical coordinate (reference ``ZStar``,
    ``HydrostaticFreeSurfaceModels.jl:26-27`` + ``z_star_vertical_
    spacing.jl``): vertical spacings scale with the column stretching
    σ = (H + η)/H, and prognostic fields are rescaled by σⁿ/σⁿ⁺¹ after the
    free-surface update so the σ-weighted content ∫ σ q dV is conserved
    to roundoff (flux-form telescoping; pinned at 1e-12 relative on the
    test configurations — see docs/VALIDATION.md for the per-config
    tolerances). Uniform-tracer PRESERVATION is exact under the explicit
    free surface (AB2-compatible η tendency) and truncation-level under
    split-explicit substepping."""

    def __repr__(self):
        return "ZStar()"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash("ZStar")


class _ScaledZGrid:
    """Ephemeral grid view whose vertical spacings are scaled by a
    per-column factor σ(x, y) — the reference's mutable vertical
    discretization (``MutableVerticalDiscretization``,
    ``src/Grids/vertical_discretization.jl:32``) expressed functionally.
    Built inside the jitted step; never stored."""

    def __init__(self, base, sigma, sigma_fc=None, sigma_cf=None):
        object.__setattr__(self, "base", base)
        object.__setattr__(self, "sigma", sigma)
        # per-location scalings (reference σᶠᶜⁿ/σᶜᶠⁿ,
        # ``z_star_vertical_spacing.jl:44-75``): over immersed bathymetry
        # the face column depths differ from the adjacent centers', so
        # the x/y flux areas must carry their own σ. Default to the
        # center σ (index-aligned), the flat-bottom behavior.
        object.__setattr__(self, "sigma_fc",
                           sigma if sigma_fc is None else sigma_fc)
        object.__setattr__(self, "sigma_cf",
                           sigma if sigma_cf is None else sigma_cf)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "base"), name)

    def dx(self, *a, **k):
        return self.base.dx(*a, **k)

    def dy(self, *a, **k):
        return self.base.dy(*a, **k)

    def dz(self, lz=Center):
        return self.sigma * self.base.dz(lz)

    def Az(self, *a, **k):
        return self.base.Az(*a, **k)

    def Ax(self, lx, ly, lz):
        s = self.sigma_fc if lx == Face else self.sigma
        return self.dy(ly, lx) * (s * self.base.dz(lz))

    def Ay(self, lx, ly, lz):
        s = self.sigma_cf if ly == Face else self.sigma
        return self.dx(lx, ly) * (s * self.base.dz(lz))

    def V(self, lx, ly, lz):
        return self.Az(lx, ly) * self.dz(lz)

    @property
    def shape(self):
        return self.base.shape

    @property
    def N(self):
        return self.base.N

    @property
    def H(self):
        return self.base.H

    @property
    def interior_slices(self):
        return self.base.interior_slices

    def axis_topo(self, axis):
        return self.base.axis_topo(axis)

    def interior(self, a):
        return self.base.interior(a)


class PrescribedVelocityFields:
    """Diagnostic-velocity mode: tracers advected by fixed analytic
    velocities (reference ``prescribed_hydrostatic_velocity_fields.jl``)."""

    def __init__(self, u=None, v=None, w=None):
        self.u = u
        self.v = v
        self.w = w


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HydrostaticState:
    u: jnp.ndarray
    v: jnp.ndarray
    w: jnp.ndarray            # diagnostic
    eta: jnp.ndarray          # (nx, ny, 1) free surface displacement
    tracers: Dict[str, jnp.ndarray]
    clock: Clock
    Gu: jnp.ndarray
    Gv: jnp.ndarray
    Geta: jnp.ndarray
    Gtracers: Dict[str, jnp.ndarray]
    particles: object = None  # LagrangianParticles state (or None)
    # persistent barotropic transports (the split-explicit free surface's
    # own prognostic state — reference barotropic_velocities,
    # initialize_split_explicit_substepping.jl:15-25; zeros otherwise)
    U: jnp.ndarray = None
    V: jnp.ndarray = None

    @property
    def velocities(self):
        return {"u": self.u, "v": self.v, "w": self.w}

    def fields(self):
        return {"u": self.u, "v": self.v, "w": self.w, "eta": self.eta,
                **self.tracers}


def _replace(state, **kw):
    return dataclasses.replace(state, **kw)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class HydrostaticFreeSurfaceModel:
    """Hydrostatic Boussinesq dynamics with a free surface.

    Mirrors the reference keyword surface
    (``hydrostatic_free_surface_model.jl:87``): grid, momentum_advection,
    tracer_advection, free_surface, tracers, buoyancy, coriolis, closure,
    forcing, boundary_conditions.
    """

    def __init__(self, grid, momentum_advection=None, tracer_advection=None,
                 free_surface=None, tracers=(), buoyancy=None, coriolis=None,
                 closure=None, forcing=None, boundary_conditions=None,
                 vertical_coordinate=None, timestepper="quasi_ab2",
                 particles=None, biogeochemistry=None, stokes_drift=None,
                 auxiliary_fields=None):
        # feature-parity fields of the reference struct
        # (hydrostatic_free_surface_model.jl:40-47)
        self.particles = particles
        self.biogeochemistry = biogeochemistry
        self.stokes_drift = stokes_drift
        self.auxiliary_fields = dict(auxiliary_fields or {})
        self.vertical_coordinate = vertical_coordinate or ZCoordinate()
        #: "quasi_ab2" (reference default) or "split_rk3" (the SSP
        #: Shu-Osher RK3 of ``split_hydrostatic_runge_kutta_3.jl:64-70``:
        #: Uᵐ⁺¹ = ζᵐ Uⁿ + γᵐ (Uᵐ + Δt Gᵐ); convex combinations, so
        #: together with BoundPreserving advection it is bound-preserving)
        if timestepper not in ("quasi_ab2", "split_rk3"):
            raise ValueError(f"unknown timestepper {timestepper!r}")
        if timestepper == "split_rk3" and isinstance(
                vertical_coordinate, ZStar):
            raise ValueError("split_rk3 supports ZCoordinate only")
        self.timestepper = timestepper
        if momentum_advection is None:
            momentum_advection = VectorInvariant()
        if tracer_advection is None:
            tracer_advection = Centered(2)
        if free_surface is None:
            # reference default: implicit on regular grids else split
            # explicit (hydrostatic_free_surface_model.jl:51-55); we default
            # to split-explicit, the scalable choice
            free_surface = SplitExplicitFreeSurface()
        from oceananigans_tpu.immersed import ImmersedBoundaryGrid
        if (isinstance(grid, ImmersedBoundaryGrid)
                and isinstance(free_surface, ImplicitFreeSurface)
                and free_surface.solver_method == "fft"):
            # the FFT eigenbasis assumes a flat bottom; with bathymetry the
            # reference materializes a PCG/matrix solver instead
            # (implicit_free_surface.jl build_implicit_step_solver)
            free_surface = ImplicitFreeSurface(
                gravitational_acceleration=free_surface.g,
                solver_method="cg", maxiter=free_surface.maxiter,
                reltol=free_surface.reltol)
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        buoyancy = regularize_buoyancy(buoyancy)
        if buoyancy is not None:
            for t in buoyancy.required_tracers:
                if t not in tracers:
                    tracers = tracers + (t,)
        for cl in closures_mod._as_tuple(closure):
            for t in getattr(cl, "required_tracers", ()):
                if t not in tracers:
                    tracers = tracers + (t,)
        if biogeochemistry is not None:
            for t in biogeochemistry.required_tracers:
                if t not in tracers:
                    tracers = tracers + (t,)

        self.grid = grid
        self.momentum_advection = momentum_advection
        b = getattr(tracer_advection, "bind_grid", None)
        self.tracer_advection = b(grid) if b is not None \
            else tracer_advection
        self.free_surface = free_surface
        self.tracer_names = tracers
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.closure = closure

        boundary_conditions = dict(boundary_conditions or {})
        locs = {"u": LOC_U, "v": LOC_V, "w": LOC_W}
        self.locations = {**locs, **{t: LOC_C for t in tracers}}
        self.bcs = {}
        for name, loc in self.locations.items():
            self.bcs[name] = regularize_field_boundary_conditions(
                boundary_conditions.get(name), grid, loc)
        # η: center-located in x,y
        self.eta_bcs = regularize_field_boundary_conditions(
            boundary_conditions.get("eta"), grid, LOC_C)

        # per-interface immersed BCs (reference ImmersedBoundaryCondition)
        from oceananigans_tpu.immersed import (
            ImmersedBoundaryGrid as _IBG, regularize_immersed_bc,
            scalar_diffusivity_of,
        )
        self.immersed_bcs = {}
        if isinstance(grid, _IBG):
            for name, loc in self.locations.items():
                rib = regularize_immersed_bc(self.bcs[name].immersed, loc)
                if rib is not None:
                    self.immersed_bcs[name] = rib
        self._ib_kappa = {
            name: scalar_diffusivity_of(
                closure, None if name in ("u", "v", "w") else name)
            for name in self.immersed_bcs}

        # AdvectiveForcing entries are summed into the forced tracer's
        # advecting velocity (reference with_advective_forcing,
        # advective_forcing.jl:74-90)
        from oceananigans_tpu.forcings import split_advective_forcings
        forcing = dict(forcing or {})
        self.forcings = {}
        self.advective_forcings = {}
        for name in self.locations:
            adv, rest = split_advective_forcings(forcing.get(name))
            if adv and name not in self.tracer_names:
                raise ValueError(
                    f"AdvectiveForcing is only supported on tracers, "
                    f"got it for {name!r}")
            if adv:
                self.advective_forcings[name] = adv
            self.forcings[name] = materialize_forcing(
                rest, name, self.locations[name])

    tree_flatten = lambda self: ((self.grid,), _ModelAux(self))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.__dict__.update(aux.d)
        obj.grid = children[0]
        return obj

    # ------------------------------------------------------------------
    def initial_state(self, time=0.0, **field_values):
        g = self.grid
        dtype = g.xC.dtype
        allowed = {"u", "v", "eta"} | set(self.tracer_names)
        unknown = set(field_values) - allowed
        if unknown:
            raise ValueError(
                f"unknown initial_state fields {sorted(unknown)}; "
                f"this model takes {sorted(allowed)}")

        def mk(name, loc):
            if name in field_values:
                return set_field(g, field_values[name], loc=loc, dtype=dtype)
            return new_field(g, dtype)

        u = mk("u", LOC_U)
        v = mk("v", LOC_V)
        eta2d = field_values.get("eta", 0.0)
        eta = self._eta_field(eta2d, dtype)
        tracers = {t: mk(t, LOC_C) for t in self.tracer_names}
        zeros2d = jnp.zeros_like(eta)
        state = HydrostaticState(
            u=u, v=v, w=new_field(g, dtype), eta=eta, tracers=tracers,
            clock=Clock.start(time, dtype),
            Gu=new_field(g, dtype), Gv=new_field(g, dtype),
            Geta=zeros2d,
            Gtracers={t: new_field(g, dtype) for t in self.tracer_names},
            particles=(self.particles.initial
                       if self.particles is not None else None),
            U=zeros2d, V=zeros2d,
        )
        state = self.update_state(state)
        # persistent barotropic transports from the initial velocities
        # (reference initialize_free_surface!,
        # initialize_split_explicit_substepping.jl:15-25)
        if isinstance(self.vertical_coordinate, ZStar):
            U0, V0 = self._barotropic_mode(
                state.u, state.v, self._sigma_at(state.eta, "fc"),
                self._sigma_at(state.eta, "cf"))
        else:
            U0, V0 = self._barotropic_mode(state.u, state.v)
        U0, V0 = self._zero_wall_transports(U0, V0)
        return _replace(state, U=U0, V=V0)

    def _eta_field(self, value, dtype):
        g = self.grid
        shape2d = (g.shape[0], g.shape[1], 1)
        if callable(value):
            x = g.xC
            y = g.yC
            vals = value(x, y)
            return jnp.broadcast_to(jnp.asarray(vals, dtype),
                                    shape2d).astype(dtype)
        return jnp.broadcast_to(jnp.asarray(value, dtype), shape2d)

    # ------------------------------------------------------------------
    def _fill_field(self, a, bcs, loc, t, dt=None, g=None):
        """Halo fill, routed through the distributed ppermute exchange
        when this model runs inside the explicit-halo shard_map step
        (parallel/shard_step.py sets ``dist_halo``)."""
        if g is None:
            g = self.grid
        ctx = getattr(self, "dist_halo", None)
        if ctx is not None:
            from oceananigans_tpu.parallel.shard_step import dist_fill_halos
            return dist_fill_halos(a, g, bcs, loc, t, dt, ctx,
                                   self.dist_topo)
        return fill_halo_regions(a, g, bcs, loc, t, dt=dt)

    def _fill_transport_halos(self, U, V):
        """x/y halo fill for the persistent barotropic transports with
        DEFAULT face-location semantics (periodic images / wall-face
        zero): under the explicit-halo distributed step the shard-local
        U/V halo strips are stale between steps (the local layout is
        rebuilt from interiors), and the substepped transport divergence
        reads them."""
        g = self.grid
        # reuse the velocities' REGULARIZED side classifications (built
        # once against the static grid — re-regularizing here would
        # inspect grid coordinates inside the traced distributed step)
        # with condition values disabled: flux/value conditions belong
        # to the 3-D fields, the transports only need the topology fill
        bcs_u, bcs_v = self.bcs["u"], self.bcs["v"]
        ctx = getattr(self, "dist_halo", None)
        if ctx is not None:
            from oceananigans_tpu.parallel.shard_step import dist_fill_xy
            U = dist_fill_xy(U, g, bcs_u, LOC_U, None, None, ctx,
                             self.dist_topo, use_values=False)
            V = dist_fill_xy(V, g, bcs_v, LOC_V, None, None, ctx,
                             self.dist_topo, use_values=False)
            return U, V
        from oceananigans_tpu.boundary_conditions import _fill_axis
        for axis in (X, Y):
            lu, ru = bcs_u.sides(axis)
            lv, rv = bcs_v.sides(axis)
            U = _fill_axis(U, g, axis, LOC_U[axis], lu, ru, None, None)
            V = _fill_axis(V, g, axis, LOC_V[axis], lv, rv, None, None)
        return U, V

    def _fill_eta_halos(self, eta):
        g = self.grid
        from oceananigans_tpu.boundary_conditions import _fill_axis
        ctx = getattr(self, "dist_halo", None)
        if ctx is not None:
            # distributed x/y fill (neighbor ppermute exchange + edge-
            # shard-only boundary fill), shared with the 3-D field path
            from oceananigans_tpu.parallel.shard_step import dist_fill_xy
            return dist_fill_xy(eta, g, self.eta_bcs,
                                (Center, Center, Center), None, None,
                                ctx, self.dist_topo, use_values=False)
        # fill x/y halos only (η has no z extent)
        for axis in (X, Y):
            lbc, rbc = self.eta_bcs.sides(axis)
            eta = _fill_axis(eta, g, axis, Center, lbc, rbc, None, None)
        return eta

    def fill_state_halos(self, state):
        from oceananigans_tpu.immersed import mask_immersed_field
        g = self.grid
        t = state.clock.time
        dtl = state.clock.last_dt
        # mask solid regions first (reference mask_immersed_model_fields!,
        # update_hydrostatic_free_surface_model_state.jl:60-69), then fill
        u = mask_immersed_field(g, state.u, LOC_U)
        v = mask_immersed_field(g, state.v, LOC_V)
        u = self._fill_field(u, self.bcs["u"], LOC_U, t, dt=dtl)
        v = self._fill_field(v, self.bcs["v"], LOC_V, t, dt=dtl)
        tracers = {
            name: self._fill_field(mask_immersed_field(g, c, LOC_C),
                                   self.bcs[name], LOC_C, t)
            for name, c in state.tracers.items()
        }
        eta = self._fill_eta_halos(state.eta)
        return _replace(state, u=u, v=v, tracers=tracers, eta=eta)

    def _sigma(self, eta):
        """z-star column stretching σ = (H + η)/H (σ = 1 on land
        columns)."""
        H = self._column_depth_static()
        return jnp.where(H > 0, 1.0 + eta / jnp.where(H > 0, H, 1.0), 1.0)

    def _sigma_at(self, eta, loc):
        """σ at a staggered horizontal location from the WET column depth
        there and η interpolated to it (reference σᶠᶜⁿ/σᶜᶠⁿ built from
        ``static_column_depthᶠᶜᵃ``, ``z_star_vertical_spacing.jl:44-75``).
        Over a bathymetry step the face depth is the min of the adjacent
        columns', so interpolating the center σ would be inconsistent
        with the face transport the tracer fluxes use."""
        if loc == "cc":
            return self._sigma(eta)
        H = self._column_depth(loc)
        eta_l = ix_f(eta) if loc == "fc" else iy_f(eta)
        return jnp.where(H > 0, 1.0 + eta_l / jnp.where(H > 0, H, 1.0),
                         jnp.ones_like(eta_l))

    def _column_depth_static(self):
        return self._column_depth("cc")

    def _active_grid(self, state):
        """The grid the dynamics see: σ-scaled under ZStar."""
        if isinstance(self.vertical_coordinate, ZStar):
            return _ScaledZGrid(self.grid, self._sigma(state.eta),
                                self._sigma_at(state.eta, "fc"),
                                self._sigma_at(state.eta, "cf"))
        return self.grid

    def compute_w(self, state, g=None):
        """Diagnose w from continuity: w(zF_k) = −∫_bottom^k ∇ₕ·𝐮 dz
        (reference ``compute_w_from_continuity.jl``)."""
        if g is None:
            g = self._active_grid(state)
        hdiv = div_xy_cc(g, state.u, state.v)
        dz = jnp.broadcast_to(g.dz(Center), g.shape)
        k = jnp.arange(g.shape[Z]).reshape(1, 1, -1)
        in_interior = (k >= g.Hz) & (k < g.Hz + g.Nz)
        contrib = jnp.where(in_interior, hdiv * dz, 0.0)
        csum = jnp.cumsum(contrib, axis=Z)
        # w at face k (bottom face of cell k) = −sum over cells k' < k
        w = -shift(csum, -1, Z)
        if isinstance(self.vertical_coordinate, ZStar):
            # dia-surface velocity ω: subtract the grid motion so ω = 0 at
            # the moving surface (∂tσ·h(k) term; ∂tσ = −∇·U/H and the full
            # column sum of the scaled divergence is exactly H ∂tσ)
            total = jnp.sum(contrib, axis=Z, keepdims=True)
            dz0 = jnp.broadcast_to(self.grid.dz(Center), self.grid.shape)
            # WET height above the LOCAL bottom (not the domain bottom):
            # over bathymetry the grid motion is distributed across the
            # wet part of the column only, so ω = 0 at the immersed
            # bottom face and at the moving surface (reference
            # ``grid_fitted_bottom.jl:147-150`` column depths feeding
            # ``_update_grid_vertical_velocity!``)
            wet = in_interior
            solid = getattr(self.grid, "solid_c", None)
            if solid is not None:
                wet = wet & ~solid
            h_below = shift(jnp.cumsum(
                jnp.where(wet, dz0, 0.0), axis=Z), -1, Z)
            h_below = jnp.where(k == 0, 0.0, h_below)
            H = self._column_depth_static()
            w = w + jnp.where(H > 0, h_below / jnp.where(H > 0, H, 1.0),
                              0.0) * total
        w = jnp.where(k == 0, 0.0, w)
        from oceananigans_tpu.immersed import mask_immersed_field
        w = mask_immersed_field(self.grid, w, LOC_W)
        w = self._fill_field(w, self.bcs["w"], LOC_W, state.clock.time,
                             g=g)
        return _replace(state, w=w)

    def update_state(self, state):
        state = self.fill_state_halos(state)
        state = self.compute_w(state)
        return state

    # ------------------------------------------------------------------
    def hydrostatic_pressure_anomaly(self, state, g=None):
        """p′(z) = −∫_z^0 b dz′ at centers (∂z p′ = b, p′(top) = 0);
        reference ``update_hydrostatic_pressure.jl``."""
        if g is None:
            g = self.grid
        if self.buoyancy is None:
            return None
        b = self.buoyancy.buoyancy_ccc(g, state.tracers)
        dz = jnp.broadcast_to(g.dz(Center), g.shape)
        k = jnp.arange(g.shape[Z]).reshape(1, 1, -1)
        in_interior = (k >= g.Hz) & (k < g.Hz + g.Nz)
        contrib = jnp.where(in_interior, b * dz, 0.0)
        total = jnp.sum(contrib, axis=Z, keepdims=True)
        below_incl = jnp.cumsum(contrib, axis=Z)
        # −∫_z^0 b dz' = −(total − ∫_bottom^z) ; center value uses the half
        # cell above: −(above-z integral) with midpoint correction
        above = total - below_incl
        p = -(above + 0.5 * contrib)
        return p

    def _top_flux_values(self, time):
        """Evaluate the TOP flux-BC values for u, v, and buoyancy-ish
        tracers (surface stress / buoyancy flux), for closures that need
        them (CATKE's convective lengths and surface TKE flux)."""
        from oceananigans_tpu.boundary_conditions import FLUX, _bc_value
        from oceananigans_tpu.fields import LOC_C, LOC_U, LOC_V
        out = {}
        for name, loc in (("u", LOC_U), ("v", LOC_V), ("b", LOC_C)):
            bcs = self.bcs.get(name)
            bc = getattr(bcs, "top", None) if bcs is not None else None
            if bc is None or bc.classification != FLUX \
                    or bc.condition is None:
                continue
            out[name] = _bc_value(bc, self.grid, 2, loc, time)
        return out

    def compute_tendencies(self, state, g=None):
        if g is None:
            g = self._active_grid(state)
        u, v, w = state.u, state.v, state.w
        tracers = state.tracers
        time = state.clock.time
        fields = state.fields()
        if self.auxiliary_fields:
            # user auxiliary fields, visible to forcings/BCs (reference
            # struct field AF, hydrostatic_free_surface_model.jl:47)
            from oceananigans_tpu.fields import set_field as _sf
            for name, val in self.auxiliary_fields.items():
                fields[name] = _sf(self.grid, val, loc=LOC_C) \
                    if not hasattr(val, "ndim") else val

        diffusivities = closures_mod.compute_diffusivities(
            self.closure, g, u, v, w, tracers, self.buoyancy,
            top_fluxes=self._top_flux_values(time))

        ma = self.momentum_advection
        if isinstance(ma, VectorInvariant):
            Gu = ma.u_tendency(g, u, v, w)
            Gv = ma.v_tendency(g, u, v, w)
        elif ma is None:
            Gu = jnp.zeros_like(u)
            Gv = jnp.zeros_like(v)
        else:
            Gu = -div_vu(g, ma, u, v, w)
            Gv = -div_vv(g, ma, u, v, w)

        if self.stokes_drift is not None:
            Gu = Gu + self.stokes_drift.x_tendency(g, u, v, w, time)
            Gv = Gv + self.stokes_drift.y_tendency(g, u, v, w, time)

        if self.coriolis is not None:
            Gu = Gu - self.coriolis.x_f_cross_U(g, u, v, w)
            Gv = Gv - self.coriolis.y_f_cross_U(g, u, v, w)

        p_anom = self.hydrostatic_pressure_anomaly(state, g)
        if p_anom is not None:
            Gu = Gu - dx_f(p_anom) / g.dx(Face, Center)
            Gv = Gv - dy_f(p_anom) / g.dy(Face, Center)
            if isinstance(self.vertical_coordinate, ZStar):
                # σ-coordinate pressure-gradient correction: the
                # horizontal gradient at constant σ-level differs from
                # the constant-z gradient by b ∂x(z) (reference
                # ``grid_slope_contribution_x``,
                # z_star_vertical_spacing.jl:125-132). On the z-star
                # grid z = σ z_ref + η.
                b = self.buoyancy.buoyancy_ccc(g, state.tracers)
                zrow = jnp.asarray(self.grid.zC, b.dtype)
                zrow = zrow.reshape(1, 1, -1)
                z_c = self._sigma(state.eta) * zrow + state.eta
                # sign: our p′ = −∫_z^0 b dz′ has ∂z p′ = +b, so the
                # constant-z gradient correction ADDS b ∂x(z)
                Gu = Gu + ix_f(b) * dx_f(z_c) / g.dx(Face, Center)
                Gv = Gv + iy_f(b) * dy_f(z_c) / g.dy(Face, Center)

        # explicit barotropic pressure gradient (explicit free surface only)
        if isinstance(self.free_surface, ExplicitFreeSurface):
            fs_g = self.free_surface.g
            Gu = Gu - fs_g * dx_f(state.eta) / g.dx(Face, Center)
            Gv = Gv - fs_g * dy_f(state.eta) / g.dy(Face, Center)

        du, dv, _ = closures_mod.momentum_flux_divergences(
            self.closure, g, u, v, w, tracers, diffusivities,
            include_implicit=False)
        Gu = Gu + du
        Gv = Gv + dv

        for name, G in (("u", None), ("v", None)):
            f = self.forcings[name]
            if f is not None:
                term = f(g, time, fields)
                if name == "u":
                    Gu = Gu + term
                else:
                    Gv = Gv + term

        Gu = apply_flux_bcs(Gu, g, self.bcs["u"], LOC_U, time, fields)
        Gv = apply_flux_bcs(Gv, g, self.bcs["v"], LOC_V, time, fields)
        from oceananigans_tpu.immersed import (
            immersed_flux_divergence, mask_immersed_field,
        )
        for name, vel, loc in (("u", u, LOC_U), ("v", v, LOC_V)):
            ib = self.immersed_bcs.get(name)
            if ib is None:
                continue
            term = immersed_flux_divergence(g, ib, loc, vel,
                                            self._ib_kappa[name], time)
            if name == "u":
                Gu = Gu + term
            else:
                Gv = Gv + term
        Gu = mask_immersed_field(g, Gu, LOC_U)
        Gv = mask_immersed_field(g, Gv, LOC_V)

        Gtracers = {}
        for name in self.tracer_names:
            c = tracers[name]
            uta, vta, wta = u, v, w
            for af in self.advective_forcings.get(name, ()):
                ua, va, wa = af.velocities(g)
                uta, vta, wta = uta + ua, vta + va, wta + wa
            Gc = -div_Uc(g, self.tracer_advection, uta, vta, wta, c)
            Gc = Gc + closures_mod.tracer_flux_divergence(
                self.closure, g, name, c, tracers, diffusivities,
                include_implicit=False)
            bgc = self.biogeochemistry
            if bgc is not None:
                reaction = bgc.transition(g, name, time, fields)
                if reaction is not None:
                    Gc = Gc + reaction
                drift = bgc.drift_velocity(name)
                if drift is not None:
                    wu, wv, ww = (jnp.zeros_like(c) + d for d in drift)
                    Gc = Gc - div_Uc(g, self.tracer_advection,
                                     wu, wv, ww, c)
            f = self.forcings[name]
            if f is not None:
                Gc = Gc + f(g, time, fields)
            Gc = apply_flux_bcs(Gc, g, self.bcs[name], LOC_C, time, fields)
            ib = self.immersed_bcs.get(name)
            if ib is not None:
                Gc = Gc + immersed_flux_divergence(
                    g, ib, LOC_C, c, self._ib_kappa[name], time)
            Gtracers[name] = mask_immersed_field(g, Gc, LOC_C)

        if self.biogeochemistry is not None:
            Gtracers = self.biogeochemistry.update_tendencies(
                g, Gtracers, time, fields)

        for hook in getattr(self, "tendency_callbacks", ()):
            G = {"u": Gu, "v": Gv, **Gtracers}
            G = hook(g, state, G)
            Gu, Gv = G["u"], G["v"]
            Gtracers = {n: G[n] for n in Gtracers}

        return Gu, Gv, Gtracers, diffusivities

    # ------------------------------------------------------------------
    def _barotropic_mode(self, u, v, sigma_fc=None, sigma_cf=None):
        """(U, V) = ∫ u dz (reference ``_compute_barotropic_mode!``).
        Under ZStar pass the face σ scalings so the transports integrate
        the MOVING cell thicknesses (σ dz), matching the thickness the
        tracer fluxes advect through."""
        g = self.grid
        dz = jnp.broadcast_to(g.dz(Center), g.shape)
        k = jnp.arange(g.shape[Z]).reshape(1, 1, -1)
        in_interior = (k >= g.Hz) & (k < g.Hz + g.Nz)
        dzm = jnp.where(in_interior, dz, 0.0)
        dzu = dzm if sigma_fc is None else sigma_fc * dzm
        dzv = dzm if sigma_cf is None else sigma_cf * dzm
        U = jnp.sum(u * dzu, axis=Z, keepdims=True)
        V = jnp.sum(v * dzv, axis=Z, keepdims=True)
        return U, V

    def _column_depth(self, loc="cc"):
        """WET column depth ∫ dz over fluid cells, at cell centers
        ("cc"), u-faces ("fc" = min of the two adjacent columns), or
        v-faces ("cf") — the reference's ``static_column_depthᶜᶜᵃ`` /
        ``ᶠᶜᵃ`` / ``ᶜᶠᵃ`` (``grid_fitted_bottom.jl:147-150``; plain grids
        reduce to Lz, ``grid_utils.jl:323-326``). The mask is
        halo-consistent so the shifted min is valid at seams."""
        g = self.grid
        dz = jnp.broadcast_to(g.dz(Center), g.shape)
        k = jnp.arange(g.shape[Z]).reshape(1, 1, -1)
        wet = (k >= g.Hz) & (k < g.Hz + g.Nz)
        solid = getattr(g, "solid_c", None)
        if solid is not None:
            wet = wet & ~solid
        H = jnp.sum(jnp.where(wet, dz, 0.0), axis=Z, keepdims=True)
        if loc == "fc":
            return jnp.minimum(H, shift(H, -1, X))
        if loc == "cf":
            return jnp.minimum(H, shift(H, -1, Y))
        return H

    def _zero_wall_transports(self, U, V):
        """Impenetrability of the barotropic transports: zero U/V on the
        wall faces of Bounded axes (the baroclinic fields get this from
        their Open BCs; the substepped transports must enforce it too).
        Under the explicit-halo distributed step a shard's local walls
        are GLOBAL walls only on the edge shards — guard on the shard
        index (interior shards' "wall" faces carry exchanged data)."""
        from oceananigans_tpu.grids.base import Bounded as _B
        g = self.grid
        ctx = getattr(self, "dist_halo", None)
        topo = getattr(self, "dist_topo", None) or (
            g.axis_topo(X), g.axis_topo(Y), g.axis_topo(Z))

        def walled(T, axis, H, N, n):
            idx = np.arange(n).reshape((-1, 1, 1) if axis == X
                                       else (1, -1, 1))
            low = (idx == H) | (idx < H)
            high = (idx == H + N) | (idx > H + N)
            if ctx is None or ctx.size(axis) == 1:
                return jnp.where(low | high, 0.0, T)
            s = jax.lax.axis_index(ctx.names[axis])
            first = s == 0
            last = s == ctx.size(axis) - 1
            T = jnp.where(jnp.logical_and(first, low), 0.0, T)
            T = jnp.where(jnp.logical_and(last, high), 0.0, T)
            return T

        if topo[X] == _B:
            U = walled(U, X, g.Hx, g.Nx, g.shape[0])
        if topo[Y] == _B:
            V = walled(V, Y, g.Hy, g.Ny, g.shape[1])
        return U, V

    def _div_transports(self, U, V):
        """2-D divergence per unit area of depth-integrated transports
        located at (f,c)/(c,f): (δx(Δy U) + δy(Δx V)) / Az."""
        g = self.grid
        return (dx_c(g.dy(Center, Face) * U)
                + dy_c(g.dx(Center, Face) * V)) / g.Az(Center, Center)

    def _split_explicit_substep(self, eta, U, V, GU, GV, dtau, fs):
        """One forward-backward barotropic substep (reference
        ``_split_explicit_free_surface!`` + `_split_explicit_barotropic_
        velocity!``, step_split_explicit_free_surface.jl:11-47)."""
        g = self.grid
        # η ← η − Δτ ∇·(U, V)
        U, V = self._zero_wall_transports(U, V)
        eta = eta - dtau * self._div_transports(U, V)
        eta = self._fill_eta_halos(eta)
        # WET column depths at the transport points: with bathymetry the
        # barotropic wave speed must see the local depth, and transports
        # through dry faces must stay zero (reference
        # step_split_explicit_free_surface.jl:31-38 + column_depthᶠᶜᵃ)
        H_fc = self._column_depth("fc")
        H_cf = self._column_depth("cf")
        U = U + dtau * (-fs.g * H_fc * dx_f(eta) / g.dx(Face, Center) + GU)
        V = V + dtau * (-fs.g * H_cf * dy_f(eta) / g.dy(Face, Center) + GV)
        U = jnp.where(H_fc > 0, U, 0.0)
        V = jnp.where(H_cf > 0, V, 0.0)
        U, V = self._zero_wall_transports(U, V)
        return eta, U, V

    def _step_free_surface_split(self, state, Gu_ab2, Gv_ab2, dt, fs):
        g = self.grid
        # slow forcing: vertically integrated AB2 tendencies
        dz = jnp.broadcast_to(g.dz(Center), g.shape)
        k = jnp.arange(g.shape[Z]).reshape(1, 1, -1)
        in_interior = (k >= g.Hz) & (k < g.Hz + g.Nz)
        dzm = jnp.where(in_interior, dz, 0.0)
        GU = jnp.sum(Gu_ab2 * dzm, axis=Z, keepdims=True)
        GV = jnp.sum(Gv_ab2 * dzm, axis=Z, keepdims=True)

        # substep from the PERSISTENT barotropic transports (reference
        # barotropic_velocities state, initialized once from the initial
        # conditions and advanced only by the substepping itself —
        # re-deriving them from the already-tendency-stepped baroclinic
        # mode here would double-count the slow forcing GU and go
        # unstable at large Δt)
        if state.U is not None:
            U0, V0 = self._fill_transport_halos(state.U, state.V)
        else:
            # legacy states (pre-round-3 checkpoints) carry no U/V
            U0, V0 = self._barotropic_mode(state.u, state.v)
        eta0 = state.eta
        dtau = fs.fractional_step * dt

        weights = np.asarray(fs.weights, dtype=np.float64)

        def substep(carry, wgt):
            eta, U, V, eta_f, U_f, V_f = carry
            eta, U, V = self._split_explicit_substep(eta, U, V, GU, GV,
                                                     dtau, fs)
            return (eta, U, V,
                    eta_f + wgt * eta, U_f + wgt * U, V_f + wgt * V), None

        zero = jnp.zeros_like(eta0)
        init = (eta0, U0, V0, zero, jnp.zeros_like(U0), jnp.zeros_like(V0))
        (eta, U, V, eta_f, U_f, V_f), _ = jax.lax.scan(
            substep, init, weights.astype(eta0.dtype))
        return eta_f, U_f, V_f

    def _implicit_fs_eigenvalues(self):
        """2-D horizontal eigenvalue table for the FFT implicit solver
        (numpy; embedded as a literal)."""
        from oceananigans_tpu.solvers.fft_poisson import poisson_eigenvalues
        g = self.grid
        lams = []
        for axis in (X, Y):
            topo = g.axis_topo(axis)
            N = g.N[axis]
            d = (g.Lx / g.Nx, g.Ly / g.Ny)[axis] if topo != "flat" else 1.0
            lam = poisson_eigenvalues(N, d, topo)
            shape = [1, 1, 1]
            shape[axis] = lam.shape[0]
            lams.append(lam.reshape(shape))
        return lams[0] + lams[1]

    def _step_free_surface_implicit(self, state, dt, fs,
                                    sigma_fc=None, sigma_cf=None):
        """Solve [∇·(gH∇) − 1/Δt²] η = (∇·U* − ηⁿ/Δt)/Δt, then return
        (η_new, correction fields)."""
        from oceananigans_tpu.solvers.transforms import dct2, idct2
        from oceananigans_tpu.grids.base import Bounded as _B, Periodic as _P

        g = self.grid
        if getattr(self, "dist_halo", None) is not None:
            # explicit-halo shard_map: the spectral/matrix solvers need
            # global transforms; CG runs shard-local with exchanged
            # halos + psum-reduced inner products
            U, V = self._barotropic_mode(state.u, state.v,
                                         sigma_fc, sigma_cf)
            divU = self._div_transports(U, V)
            rhs = (divU - state.eta / dt) / dt
            eta = self._implicit_fs_cg(state, rhs, dt, fs)
            return self._fill_eta_halos(eta)
        U, V = self._barotropic_mode(state.u, state.v, sigma_fc, sigma_cf)
        divU = self._div_transports(U, V)
        rhs = (divU - state.eta / dt) / dt

        if fs.solver_method == "fft":
            H0 = float(g.Lz)    # flat-bottom depth (FFT path requirement)
            sx, sy, _ = g.interior_slices
            r = rhs[sx, sy, :]
            if poisson_transform() == "matmul":
                from oceananigans_tpu.solvers.matmul_poisson import (
                    MatmulHorizontalBasis,
                )
                basis = getattr(self, "_fs_basis", None)
                if basis is None:
                    basis = MatmulHorizontalBasis(g)
                    object.__setattr__(self, "_fs_basis", basis)
                xh = basis.forward(r)
                denom = (fs.g * H0
                         * basis.lam2d.astype(r.dtype) - 1.0 / (dt * dt))
                x = basis.inverse(xh / denom)
            else:
                fft_axes = [ax for ax in (X, Y)
                            if g.axis_topo(ax) == _P and g.N[ax] > 1]
                dct_axes = [ax for ax in (X, Y)
                            if g.axis_topo(ax) == _B and g.N[ax] > 1]
                x = r
                for ax in dct_axes:
                    x = dct2(x, ax)
                for ax in fft_axes:
                    x = jnp.fft.fft(x, axis=ax)
                lam = self._implicit_fs_eigenvalues()  # numpy (Nx,Ny,1)
                denom = (fs.g * H0 * lam
                         - 1.0 / (dt * dt)).astype(np.float64)
                x = x / denom
                for ax in fft_axes:
                    x = jnp.fft.ifft(x, axis=ax)
                x = jnp.real(x)
                for ax in dct_axes:
                    x = idct2(x, ax)
            eta = jnp.zeros_like(state.eta).at[sx, sy, :].set(
                x.astype(state.eta.dtype))
        elif fs.solver_method == "matrix":
            eta = self._implicit_fs_matrix(state, rhs, dt, fs)
        else:
            eta = self._implicit_fs_cg(state, rhs, dt, fs)
        return self._fill_eta_halos(eta)

    def _implicit_fs_matrix(self, state, rhs, dt, fs):
        """Assemble the volume-weighted pentadiagonal operator
        Az·L = Σ_faces a_f (η_nb − η_c) − Az η/Δt² (symmetric by
        construction) and solve with the HeptadiagonalIterativeSolver
        (reference ``matrix_implicit_free_surface_solver.jl:18``)."""
        from oceananigans_tpu.grids.base import Periodic as _P
        from oceananigans_tpu.solvers.matrix_solver import (
            HeptadiagonalIterativeSolver, StencilMatrix,
        )
        g = self.grid
        sx, sy, _ = g.interior_slices
        shp = (g.Nx, g.Ny, 1)
        H_fc = self._column_depth("fc")
        H_cf = self._column_depth("cf")

        def b2(m):
            return jnp.broadcast_to(m, g.shape[:2] + (1,))[sx, sy, :]

        # face conductances a_f = g H Δy/Δx (zero on bounded walls)
        ax = fs.g * b2(H_fc) * b2(g.dy(Center, Face)) \
            / b2(g.dx(Face, Center))
        ay = fs.g * b2(H_cf) * b2(g.dx(Center, Face)) \
            / b2(g.dy(Face, Center))
        per_x = g.axis_topo(X) == _P
        per_y = g.axis_topo(Y) == _P
        if not per_x:
            ax = ax.at[0, :, :].set(0.0)
        if not per_y:
            ay = ay.at[:, 0, :].set(0.0)
        Az = b2(g.Az(Center, Center))
        A = StencilMatrix(ax=ax, ay=ay, extra=-Az / (dt * dt),
                          periodic=(per_x, per_y, False))
        solver = HeptadiagonalIterativeSolver(
            A, maxiter=fs.maxiter, reltol=fs.reltol,
            preconditioner=getattr(fs, "preconditioner", "jacobi"))
        x, _, _ = solver.solve(Az * rhs[sx, sy, :])
        return jnp.zeros_like(state.eta).at[sx, sy, :].set(
            x.astype(state.eta.dtype))

    def _implicit_fs_cg(self, state, rhs, dt, fs):
        """Preconditioned CG on the 2-D Helmholtz operator (reference
        ``pcg_implicit_free_surface_solver.jl:18``) — works on any grid
        (lat-lon, stretched, bathymetry)."""
        from oceananigans_tpu.solvers.conjugate_gradient import (
            conjugate_gradient,
        )
        g = self.grid
        H_fc = self._column_depth("fc")
        H_cf = self._column_depth("cf")
        sx, sy, _ = g.interior_slices
        idx = np.zeros((g.shape[0], g.shape[1], 1), bool)
        idx[sx, sy, :] = True
        idx_j = jnp.asarray(idx)

        def L(eta):
            eta = self._fill_eta_halos(eta)
            gx = fs.g * H_fc * dx_f(eta) / g.dx(Face, Center)
            gy = fs.g * H_cf * dy_f(eta) / g.dy(Face, Center)
            div = (dx_c(g.dy(Center, Face) * gx)
                   + dy_c(g.dx(Center, Face) * gy)) / g.Az(Center, Center)
            out = div - eta / (dt * dt)
            return jnp.where(idx_j, out, 0.0)

        b = jnp.where(idx_j, rhs, 0.0)
        eta0 = jnp.zeros_like(b)
        ctx = getattr(self, "dist_halo", None)
        dot = None
        if ctx is not None:
            def dot(x, y):
                local = sum(jnp.sum(a * b2) for a, b2 in zip(
                    jax.tree_util.tree_leaves(x),
                    jax.tree_util.tree_leaves(y)))
                for axis in (0, 1):
                    if ctx.size(axis) > 1:
                        local = jax.lax.psum(local, ctx.names[axis])
                return local
        eta, _, _ = conjugate_gradient(L, b, eta0, maxiter=fs.maxiter,
                                       reltol=fs.reltol, dot=dot)
        return eta

    def _barotropic_correct(self, state, U_target, V_target,
                            sigma_fc=None, sigma_cf=None):
        """u ← u + (Ū − ∫u dz)/H with wet depths; dry columns untouched
        (reference ``barotropic_split_explicit_corrector.jl``). Under
        ZStar the baroclinic transport and the column thickness are both
        σ-scaled (reference column_depth = H + η there)."""
        from oceananigans_tpu.immersed import mask_immersed_field
        H_fc = self._column_depth("fc")
        H_cf = self._column_depth("cf")
        if sigma_fc is not None:
            H_fc = H_fc * sigma_fc
            H_cf = H_cf * sigma_cf
        U, V = self._barotropic_mode(state.u, state.v, sigma_fc, sigma_cf)
        du = jnp.where(H_fc > 0, (U_target - U)
                       / jnp.where(H_fc > 0, H_fc, 1.0), 0.0)
        dv = jnp.where(H_cf > 0, (V_target - V)
                       / jnp.where(H_cf > 0, H_cf, 1.0), 0.0)
        u = mask_immersed_field(self.grid, state.u + du, LOC_U)
        v = mask_immersed_field(self.grid, state.v + dv, LOC_V)
        return _replace(state, u=u, v=v)

    # ------------------------------------------------------------------
    def step(self, state, dt, chi=0.1):
        # normalize dt to the state dtype: a numpy float64 scalar would
        # strongly promote a float32 state under jax_enable_x64
        dt = jnp.asarray(dt, state.u.dtype)
        if self.timestepper == "split_rk3":
            state = self._step_split_rk3(state, dt)
        else:
            state = self._step_qab2(state, dt, chi)
        # Lagrangian particles advect at the end of the step (reference
        # quasi_adams_bashforth_2.jl:109 step_lagrangian_particles!)
        if self.particles is not None and state.particles is not None:
            parts = self.particles.step(
                self.grid, state.particles, state.u, state.v, state.w,
                state.fields(), dt)
            state = _replace(state, particles=parts)
        return state

    def _substep_euler(self, state, dt):
        """One forward-Euler substep (tendencies -> free surface ->
        correction), the building block of split_rk3. Returns the
        stepped state (halos filled) and the diffusivities."""
        g = self.grid
        state = self.update_state(state)
        Gu, Gv, Gt, diffusivities = self.compute_tendencies(state)
        u = state.u + dt * Gu
        v = state.v + dt * Gv
        tracers = {name: state.tracers[name] + dt * Gt[name]
                   for name in self.tracer_names}
        fs = self.free_surface
        if isinstance(fs, ExplicitFreeSurface):
            # Euler η step from the time-n transports — the same time
            # level the tracer fluxes used (free-surface/tracer
            # compatibility; reference explicit_rk3_step_free_surface!)
            U, V = self._barotropic_mode(state.u, state.v)
            eta = state.eta - dt * self._div_transports(U, V)
            state2 = _replace(state, u=u, v=v, tracers=tracers, eta=eta)
            state2 = self.fill_state_halos(state2)
        elif isinstance(fs, ImplicitFreeSurface):
            state2 = _replace(state, u=u, v=v, tracers=tracers)
            state2 = self.fill_state_halos(state2)
            eta = self._step_free_surface_implicit(state2, dt, fs)
            u = state2.u - dt * fs.g * dx_f(eta) / g.dx(Face, Center)
            v = state2.v - dt * fs.g * dy_f(eta) / g.dy(Face, Center)
            state2 = _replace(state2, u=u, v=v, eta=eta)
            state2 = self.fill_state_halos(state2)
        else:
            eta_f, U_f, V_f = self._step_free_surface_split(
                _replace(state, u=u, v=v), Gu, Gv, dt, fs)
            state2 = _replace(state, u=u, v=v, tracers=tracers,
                              eta=eta_f, U=U_f, V=V_f)
            state2 = self.fill_state_halos(state2)
            state2 = self._barotropic_correct(state2, U_f, V_f)
        return state2, diffusivities

    def _step_split_rk3(self, state, dt):
        """SSP (Shu-Osher) RK3 against the stored previous state
        (reference ``split_hydrostatic_runge_kutta_3.jl``): each substep
        is a full-Δt Euler step (with its own free-surface solve)
        convex-combined with Ψⁿ."""
        psi_u, psi_v = state.u, state.v
        psi_eta = state.eta
        psi_tr = state.tracers
        psi_U, psi_V = state.U, state.V
        s = state
        diffusivities = None
        for gamma, zeta in ((1.0, 0.0), (0.25, 0.75),
                            (2.0 / 3.0, 1.0 / 3.0)):
            s2, diffusivities = self._substep_euler(s, dt)
            upd = {}
            if psi_U is not None and s2.U is not None:
                upd = dict(U=zeta * psi_U + gamma * s2.U,
                           V=zeta * psi_V + gamma * s2.V)
            s = _replace(
                s2,
                u=zeta * psi_u + gamma * s2.u,
                v=zeta * psi_v + gamma * s2.v,
                eta=zeta * psi_eta + gamma * s2.eta,
                tracers={n: zeta * psi_tr[n] + gamma * s2.tracers[n]
                         for n in self.tracer_names}, **upd)
            s = self.fill_state_halos(s)
        s = self._implicit_diffusion(s, diffusivities, dt)
        s = _replace(s, clock=tick(s.clock, dt))
        return self.update_state(s)

    def _step_qab2(self, state, dt, chi=0.1):
        """Quasi-AB2 step with the configured free surface (reference
        ``hydrostatic_free_surface_ab2_step.jl:12-33``)."""
        g = self.grid
        state = self.update_state(state)
        Gu, Gv, Gt, diffusivities = self.compute_tendencies(state)
        c_now, c_prev = ab2_coefficients(state.clock.iteration, chi)

        zstar = isinstance(self.vertical_coordinate, ZStar)
        sigma_fc = sigma_cf = None
        if zstar:
            # store σ-WEIGHTED tendencies: the AB2 memory term Gⁿ⁻¹ was
            # computed on the σⁿ⁻¹ grid, and only σ-weighted tendencies
            # telescope exactly across grid updates (conservation). The
            # face σ come from the face WET depths (reference σᶠᶜⁿ),
            # consistent with the flux areas in ``_ScaledZGrid``.
            sigma_n = self._sigma(state.eta)
            sigma_fc = self._sigma_at(state.eta, "fc")
            sigma_cf = self._sigma_at(state.eta, "cf")
            Gu = Gu * sigma_fc
            Gv = Gv * sigma_cf
            Gt = {name: Gc * sigma_n for name, Gc in Gt.items()}

        Gu_ab2 = c_now * Gu + c_prev * state.Gu
        Gv_ab2 = c_now * Gv + c_prev * state.Gv

        if zstar:
            u = state.u + dt * Gu_ab2 / sigma_fc
            v = state.v + dt * Gv_ab2 / sigma_cf
            tracers = {
                name: state.tracers[name]
                + dt * (c_now * Gt[name]
                        + c_prev * state.Gtracers[name]) / sigma_n
                for name in self.tracer_names
            }
        else:
            u = state.u + dt * Gu_ab2
            v = state.v + dt * Gv_ab2
            tracers = {
                name: state.tracers[name]
                + dt * (c_now * Gt[name] + c_prev * state.Gtracers[name])
                for name in self.tracer_names
            }

        fs = self.free_surface
        Geta = None
        if isinstance(fs, ExplicitFreeSurface):
            # η is an AB2 prognostic with Gη = −∇·U computed from the
            # SAME time-n transports whose fluxes move the tracers
            # (reference ``explicit_ab2_step_free_surface!`` +
            # ``compute_free_surface_tendency!``): this discrete
            # compatibility keeps a uniform tracer exactly uniform under
            # ZStar (σⁿ⁺¹ − σⁿ = Δt Gη_ab2 / H telescopes against the
            # σ-weighted tracer flux divergence). NOTE: no wall-zeroing
            # here — the transports must match the tracer fluxes' column
            # sums bit-for-bit (wall faces carry zero velocity already).
            U_s, V_s = self._barotropic_mode(state.u, state.v,
                                             sigma_fc, sigma_cf)
            Geta = -self._div_transports(U_s, V_s)
            Geta_ab2 = c_now * Geta + c_prev * state.Geta
            eta = state.eta + dt * Geta_ab2
            state2 = _replace(state, u=u, v=v, tracers=tracers, eta=eta)
            state2 = self.fill_state_halos(state2)
        elif isinstance(fs, ImplicitFreeSurface):
            state2 = _replace(state, u=u, v=v, tracers=tracers)
            state2 = self.fill_state_halos(state2)
            eta = self._step_free_surface_implicit(state2, dt, fs,
                                                   sigma_fc, sigma_cf)
            u = state2.u - dt * fs.g * dx_f(eta) / g.dx(Face, Center)
            v = state2.v - dt * fs.g * dy_f(eta) / g.dy(Face, Center)
            state2 = _replace(state2, u=u, v=v, eta=eta)
            state2 = self.fill_state_halos(state2)
        else:
            eta_f, U_f, V_f = self._step_free_surface_split(
                _replace(state, u=u, v=v), Gu_ab2, Gv_ab2, dt, fs)
            state2 = _replace(state, u=u, v=v, tracers=tracers, eta=eta_f,
                              U=U_f, V=V_f)
            state2 = self.fill_state_halos(state2)
            state2 = self._barotropic_correct(state2, U_f, V_f,
                                              sigma_fc, sigma_cf)

        # z-star grid update (reference z_star_vertical_spacing.jl): the
        # water columns stretched from σⁿ to σⁿ⁺¹; rescale prognostic
        # fields so ∫ σ q dV is conserved to roundoff (telescoping)
        if zstar:
            sigma_np1 = self._sigma(state2.eta)
            ratio = sigma_n / sigma_np1
            u2 = state2.u * (sigma_fc / self._sigma_at(state2.eta, "fc"))
            v2 = state2.v * (sigma_cf / self._sigma_at(state2.eta, "cf"))
            tr2 = {name: c * ratio for name, c in state2.tracers.items()}
            state2 = _replace(state2, u=u2, v=v2, tracers=tr2)

        state2 = _replace(state2, Gu=Gu, Gv=Gv, Gtracers=Gt,
                          **({"Geta": Geta} if Geta is not None else {}))
        state2 = self._implicit_diffusion(state2, diffusivities, dt)
        state2 = _replace(state2, clock=tick(state2.clock, dt))
        return self.update_state(state2)

    def _implicit_diffusion(self, state, diffusivities, dt):
        if not closures_mod.closure_is_vertically_implicit(self.closure):
            return state
        u, v, tracers = closures_mod.implicit_vertical_diffusion_step(
            self.grid, self.closure, diffusivities, dt,
            u=state.u, v=state.v, tracers=state.tracers)
        return _replace(state, u=u, v=v, tracers=tracers)

    def cfl_timescale(self, state):
        return cell_advection_timescale(self.grid, state.u, state.v,
                                        state.w)

    def diffusion_timescale(self, state):
        """Δmin²/ν_max for the configured closures (reference
        ``cell_diffusion_timescale``, used by TimeStepWizard's
        diffusive_cfl)."""
        diff = closures_mod.compute_diffusivities(
            self.closure, self.grid, state.u, state.v, state.w,
            state.tracers, self.buoyancy)
        return closures_mod.cell_diffusion_timescale(
            self.closure, self.grid, diff)

    def __repr__(self):
        return (f"HydrostaticFreeSurfaceModel(grid={self.grid!r}, "
                f"free_surface={self.free_surface!r}, "
                f"tracers={self.tracer_names})")


jax.tree_util.register_pytree_node(
    HydrostaticFreeSurfaceModel,
    lambda m: m.tree_flatten(),
    HydrostaticFreeSurfaceModel.tree_unflatten,
)
