"""Turbulence closures: diffusive/viscous flux divergences + eddy coefficients.

Reference layer: ``src/TurbulenceClosures/`` (SURVEY.md §2.13). A closure
provides the momentum stress divergences (reference ``∂ⱼ_τ₁ⱼ`` etc.) and the
tracer flux divergence (``∇_dot_qᶜ``), a ``compute_diffusivities`` pass run
each ``update_state`` (``update_nonhydrostatic_model_state.jl:59-70``), and
an explicit vs vertically-implicit time discretization
(``implicit_explicit_time_discretization.jl``) that routes vertical
diffusion into a batched tridiagonal ``implicit_step``
(``vertically_implicit_diffusion_solver.jl:38-60``).

Design: fluxes are whole-array expressions with the same
staggering as the advective fluxes, fused by XLA into the tendency kernel.
Eddy coefficients (Smagorinsky, AMD, convective adjustment) are plain
center-located arrays recomputed functionally each step. The implicit
vertical solve is the ``lax.scan`` Thomas solver batched over all (i,j)
columns and tracers.
"""

from __future__ import annotations

import jax.numpy as jnp

from oceananigans_tpu.grids.base import Center, Face
from oceananigans_tpu.ops.operators import (
    dx_c, dx_f, dy_c, dy_f, dz_c, dz_f,
    ix_c, ix_f, iy_c, iy_f, iz_c, iz_f, shift,
)
from oceananigans_tpu.solvers.tridiagonal import tridiagonal_solve

__all__ = [
    "ScalarDiffusivity", "VerticalScalarDiffusivity",
    "HorizontalScalarDiffusivity", "ScalarBiharmonicDiffusivity",
    "VerticalScalarBiharmonicDiffusivity",
    "HorizontalScalarBiharmonicDiffusivity",
    "SmagorinskyLilly", "DynamicSmagorinsky", "Smagorinsky",
    "LillyCoefficient", "DynamicCoefficient",
    "AnisotropicMinimumDissipation",
    "ConvectiveAdjustmentVerticalDiffusivity",
    "ExplicitTimeDiscretization", "VerticallyImplicitTimeDiscretization",
    "compute_diffusivities", "momentum_flux_divergences",
    "tracer_flux_divergence", "implicit_vertical_diffusion_step",
    "closure_is_vertically_implicit", "viscosity", "diffusivity",
]

X, Y, Z = 0, 1, 2

ExplicitTimeDiscretization = "explicit"
VerticallyImplicitTimeDiscretization = "vertically_implicit"


def _kappa_for(kappa, name):
    """Per-tracer diffusivity: scalar or dict keyed by tracer name."""
    if isinstance(kappa, dict):
        return kappa.get(name, 0.0)
    return kappa


# ---------------------------------------------------------------------------
# Generic flux-divergence assembly.
#
# Diffusive fluxes mirror the advective flux staggering:
#   tracer  c(c,c,c): qx at (f,c,c), qy at (c,f,c), qz at (c,c,f)
#   u(f,c,c): τxx at (c,c,c), τxy at (f,f,c), τxz at (f,c,f)
#   v(c,f,c): τyx at (f,f,c), τyy at (c,c,c), τyz at (c,f,f)
#   w(c,c,f): τzx at (f,c,f), τzy at (c,f,f), τzz at (c,c,c)
# ν is center-located (c,c,c); it is interpolated onto each flux point.
# ---------------------------------------------------------------------------

def _nu_at(nu, to):
    """Interpolate a center-located coefficient to a staggered flux point.
    ``to`` is a string of axis letters to face-shift, e.g. "xy"."""
    if not hasattr(nu, "ndim") or nu.ndim == 0:
        return nu
    for ax in to:
        nu = {"x": ix_f, "y": iy_f, "z": iz_f}[ax](nu)
    return nu


def _div_u_fluxes(grid, fx_ccc, fy_ffc, fz_fcf):
    """Divergence of (f,c,c)-located-field fluxes. On immersed grids every
    flux is zeroed through/inside the boundary (reference
    ``immersed_boundary_condition.jl`` conditional fluxes ⇒ the default
    free-slip, no-flux immersed boundary)."""
    from oceananigans_tpu.immersed import mask_flux
    fx_ccc = mask_flux(grid, fx_ccc, (Center, Center, Center))
    fy_ffc = mask_flux(grid, fy_ffc, (Face, Face, Center))
    fz_fcf = mask_flux(grid, fz_fcf, (Face, Center, Face))
    return (dx_f(grid.Ax(Center, Center, Center) * fx_ccc)
            + dy_c(grid.Ay(Face, Face, Center) * fy_ffc)
            + dz_c(grid.Az(Face, Center) * fz_fcf)) / grid.V(
                Face, Center, Center)


def _div_v_fluxes(grid, fx_ffc, fy_ccc, fz_cff):
    from oceananigans_tpu.immersed import mask_flux
    fx_ffc = mask_flux(grid, fx_ffc, (Face, Face, Center))
    fy_ccc = mask_flux(grid, fy_ccc, (Center, Center, Center))
    fz_cff = mask_flux(grid, fz_cff, (Center, Face, Face))
    return (dx_c(grid.Ax(Face, Face, Center) * fx_ffc)
            + dy_f(grid.Ay(Center, Center, Center) * fy_ccc)
            + dz_c(grid.Az(Center, Face) * fz_cff)) / grid.V(
                Center, Face, Center)


def _div_w_fluxes(grid, fx_fcf, fy_cff, fz_ccc):
    from oceananigans_tpu.immersed import mask_flux
    fx_fcf = mask_flux(grid, fx_fcf, (Face, Center, Face))
    fy_cff = mask_flux(grid, fy_cff, (Center, Face, Face))
    fz_ccc = mask_flux(grid, fz_ccc, (Center, Center, Center))
    return (dx_c(grid.Ax(Face, Center, Face) * fx_fcf)
            + dy_c(grid.Ay(Center, Face, Face) * fy_cff)
            + dz_f(grid.Az(Center, Center) * fz_ccc)) / grid.V(
                Center, Center, Face)


def _div_c_fluxes(grid, fx_fcc, fy_cfc, fz_ccf):
    from oceananigans_tpu.immersed import mask_flux
    fx_fcc = mask_flux(grid, fx_fcc, (Face, Center, Center))
    fy_cfc = mask_flux(grid, fy_cfc, (Center, Face, Center))
    fz_ccf = mask_flux(grid, fz_ccf, (Center, Center, Face))
    return (dx_c(grid.Ax(Face, Center, Center) * fx_fcc)
            + dy_c(grid.Ay(Center, Face, Center) * fy_cfc)
            + dz_c(grid.Az(Center, Center) * fz_ccf)) / grid.V(
                Center, Center, Center)


def _laplacian_momentum_divs(grid, nu_ccc, u, v, w, include_z=True,
                             include_h=True):
    """(∇·τ)ᵤ,ᵥ,... for an isotropic (possibly spatially-varying) viscosity
    in "gradient" (Laplacian) form — matches the reference's
    `viscous_flux_ux = -ν ∂x u` family for ScalarDiffusivity."""
    zeros_u = jnp.zeros_like(u)

    # u fluxes
    fxx = (_nu_at(nu_ccc, "") * dx_c(u) / grid.dx(Center, Center)
           if include_h else zeros_u)
    fxy = (_nu_at(nu_ccc, "xy") * dy_f(u) / grid.dy(Face, Face)
           if include_h else zeros_u)
    fxz = (_nu_at(nu_ccc, "xz") * dz_f(u) / grid.dz(Face)
           if include_z else zeros_u)
    # v fluxes
    fyx = (_nu_at(nu_ccc, "xy") * dx_f(v) / grid.dx(Face, Face)
           if include_h else zeros_u)
    fyy = (_nu_at(nu_ccc, "") * dy_c(v) / grid.dy(Center, Center)
           if include_h else zeros_u)
    fyz = (_nu_at(nu_ccc, "yz") * dz_f(v) / grid.dz(Face)
           if include_z else zeros_u)
    # w fluxes
    fzx = (_nu_at(nu_ccc, "xz") * dx_f(w) / grid.dx(Face, Center)
           if include_h else zeros_u)
    fzy = (_nu_at(nu_ccc, "yz") * dy_f(w) / grid.dy(Face, Center)
           if include_h else zeros_u)
    fzz = (_nu_at(nu_ccc, "") * dz_c(w) / grid.dz(Center)
           if include_z else zeros_u)

    du = _div_u_fluxes(grid, fxx, fxy, fxz)
    dv = _div_v_fluxes(grid, fyx, fyy, fyz)
    dw = _div_w_fluxes(grid, fzx, fzy, fzz)
    return du, dv, dw


def _laplacian_tracer_div(grid, kappa_ccc, c, include_z=True,
                          include_h=True):
    fx = (_nu_at(kappa_ccc, "x") * dx_f(c) / grid.dx(Face, Center)
          if include_h else 0.0)
    fy = (_nu_at(kappa_ccc, "y") * dy_f(c) / grid.dy(Face, Center)
          if include_h else 0.0)
    fz = (_nu_at(kappa_ccc, "z") * dz_f(c) / grid.dz(Face)
          if include_z else 0.0)
    zero = jnp.zeros_like(c)
    return _div_c_fluxes(grid,
                         fx if include_h else zero,
                         fy if include_h else zero,
                         fz if include_z else zero)


# ---------------------------------------------------------------------------
# Closure classes
# ---------------------------------------------------------------------------

class AbstractClosure:
    time_discretization = ExplicitTimeDiscretization
    #: closures needing eddy coefficients computed each step override this
    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        return None

    @property
    def vertically_implicit(self):
        return (self.time_discretization
                == VerticallyImplicitTimeDiscretization)

    def required_halo(self):
        return 1


class ScalarDiffusivity(AbstractClosure):
    """Constant (or per-tracer) ν/κ Laplacian diffusion (reference
    ``scalar_diffusivity.jl``). ``isotropy``: "iso" (all directions),
    "vertical", "horizontal"."""

    def __init__(self, nu=0.0, kappa=0.0, isotropy="iso",
                 time_discretization=ExplicitTimeDiscretization):
        self.nu = nu
        self.kappa = kappa
        self.isotropy = isotropy
        self.time_discretization = time_discretization

    def _coeff(self, grid, c):
        """Materialize a coefficient: number, center-located array, or a
        callable ``nu(x, y, z)`` evaluated at cell centers (reference
        ``discrete_diffusion_function.jl`` continuous form)."""
        if callable(c):
            from oceananigans_tpu.fields import set_field
            return set_field(grid, c)
        return c

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        include_z = self.isotropy != "horizontal" and (
            include_implicit or not self.vertically_implicit)
        include_h = self.isotropy != "vertical"
        nu = self._coeff(grid, self.nu)
        if not include_h:
            if not include_z:
                return 0.0, 0.0, 0.0
            fxz = _nu_at(nu, "xz") * dz_f(u) / grid.dz(Face)
            fyz = _nu_at(nu, "yz") * dz_f(v) / grid.dz(Face)
            fzz = nu * dz_c(w) / grid.dz(Center)
            zero = jnp.zeros_like(u)
            du = _div_u_fluxes(grid, zero, zero, fxz)
            dv = _div_v_fluxes(grid, zero, zero, fyz)
            dw = _div_w_fluxes(grid, zero, zero, fzz)
            return du, dv, dw
        du, dv, dw = _laplacian_momentum_divs(grid, nu, u, v, w,
                                              include_z=include_z)
        return du, dv, dw

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        include_z = self.isotropy != "horizontal" and (
            include_implicit or not self.vertically_implicit)
        include_h = self.isotropy != "vertical"
        kappa = self._coeff(grid, _kappa_for(self.kappa, name))
        return _laplacian_tracer_div(grid, kappa, c,
                                     include_z=include_z,
                                     include_h=include_h)

    # vertical coefficients for the implicit solve (face-located in z)
    def vertical_nu(self, grid, diffusivities):
        if self.isotropy == "horizontal":
            return 0.0
        nu = self._coeff(grid, self.nu)
        return _nu_at(nu, "z") if hasattr(nu, "ndim") and nu.ndim else nu

    def vertical_kappa(self, grid, diffusivities, name):
        if self.isotropy == "horizontal":
            return 0.0
        k = self._coeff(grid, _kappa_for(self.kappa, name))
        return _nu_at(k, "z") if hasattr(k, "ndim") and k.ndim else k

    def __repr__(self):
        return (f"ScalarDiffusivity(ν={self.nu}, κ={self.kappa}, "
                f"{self.isotropy}, {self.time_discretization})")


def VerticalScalarDiffusivity(nu=0.0, kappa=0.0,
                              time_discretization=ExplicitTimeDiscretization):
    return ScalarDiffusivity(nu, kappa, isotropy="vertical",
                             time_discretization=time_discretization)


def HorizontalScalarDiffusivity(nu=0.0, kappa=0.0):
    return ScalarDiffusivity(nu, kappa, isotropy="horizontal")


class ScalarBiharmonicDiffusivity(AbstractClosure):
    """∇⁴ hyperdiffusion with constant coefficients (reference
    ``scalar_biharmonic_diffusivity.jl``): flux divergence of the Laplacian,
    applied twice with a sign flip."""

    def __init__(self, nu=0.0, kappa=0.0, isotropy="iso"):
        self.nu = nu
        self.kappa = kappa
        self.isotropy = isotropy

    def required_halo(self):
        return 2

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        include_z = self.isotropy != "horizontal"
        include_h = self.isotropy != "vertical"
        lu, lv, lw = _laplacian_momentum_divs(grid, 1.0, u, v, w,
                                              include_z=include_z,
                                              include_h=include_h)
        du, dv, dw = _laplacian_momentum_divs(grid, self.nu, lu, lv, lw,
                                              include_z=include_z,
                                              include_h=include_h)
        return -du, -dv, -dw

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        include_z = self.isotropy != "horizontal"
        include_h = self.isotropy != "vertical"
        lc = _laplacian_tracer_div(grid, 1.0, c, include_z=include_z,
                                   include_h=include_h)
        return -_laplacian_tracer_div(grid, _kappa_for(self.kappa, name), lc,
                                      include_z=include_z,
                                      include_h=include_h)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"ScalarBiharmonicDiffusivity(ν={self.nu}, κ={self.kappa})"


def _strain_rate_products_ccc(grid, u, v, w):
    """Σᵢⱼ SᵢⱼSᵢⱼ at cell centers. Diagonal components are natively (c,c,c);
    off-diagonals live at edges and are interpolated back to centers."""
    Sxx = dx_c(u) / grid.dx(Center, Center)
    Syy = dy_c(v) / grid.dy(Center, Center)
    Szz = dz_c(w) / grid.dz(Center)
    # Sxy at (f,f,c)
    Sxy = 0.5 * (dy_f(u) / grid.dy(Face, Face) + dx_f(v) / grid.dx(Face, Face))
    # Sxz at (f,c,f)
    Sxz = 0.5 * (dz_f(u) / grid.dz(Face) + dx_f(w) / grid.dx(Face, Center))
    # Syz at (c,f,f)
    Syz = 0.5 * (dz_f(v) / grid.dz(Face) + dy_f(w) / grid.dy(Face, Center))
    return (Sxx * Sxx + Syy * Syy + Szz * Szz
            + 2.0 * ix_c(iy_c(Sxy * Sxy))
            + 2.0 * ix_c(iz_c(Sxz * Sxz))
            + 2.0 * iy_c(iz_c(Syz * Syz)))


def _delta_filter_ccc(grid):
    """(Δx Δy Δz)^(1/3) filter width at centers."""
    return (grid.dx(Center, Center) * grid.dy(Center, Center)
            * grid.dz(Center)) ** (1.0 / 3.0)


class SmagorinskyLilly(AbstractClosure):
    """Smagorinsky-Lilly LES closure (reference ``Smagorinskys/``,
    ``smagorinsky.jl`` + ``lilly_coefficient.jl``):

    νₑ = (C Δ)² √(Σ 2SᵢⱼSᵢⱼ) ς,  ς² = max(0, 1 − N²/(Cb Pr |S|²)),
    κₑ = νₑ / Pr.
    """

    def __init__(self, C=0.16, Cb=1.0, Pr=1.0):
        self.C = float(C)
        self.Cb = float(Cb)
        self.Pr = Pr

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        from oceananigans_tpu.buoyancy import buoyancy_frequency
        tr2 = 2.0 * _strain_rate_products_ccc(grid, u, v, w)
        delta = _delta_filter_ccc(grid)
        if buoyancy is not None and self.Cb != 0.0:
            N2 = iz_c(buoyancy_frequency(grid, buoyancy, tracers))
            Pr = _kappa_for(self.Pr, None) or 1.0
            denom = jnp.maximum(tr2, 1e-30)
            stability = jnp.sqrt(jnp.clip(
                1.0 - self.Cb * N2 / (Pr * denom), 0.0, 1.0))
        else:
            stability = 1.0
        nu_e = (self.C * delta) ** 2 * jnp.sqrt(tr2) * stability
        return {"nu_e": nu_e}

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        return _laplacian_momentum_divs(grid, diffusivities["nu_e"], u, v, w)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        Pr = _kappa_for(self.Pr, name)
        return _laplacian_tracer_div(grid, diffusivities["nu_e"] / Pr, c)

    def vertical_nu(self, grid, diffusivities):
        return 0.0   # explicit-only in this MVP

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"SmagorinskyLilly(C={self.C}, Cb={self.Cb}, Pr={self.Pr})"


def _box_filter_ccc(a):
    """Top-hat 2Δ test filter at centers (trapezoidal 3-point per axis)."""
    fx = 0.25 * (shift(a, -1, X) + 2.0 * a + shift(a, 1, X))
    fy = 0.25 * (shift(fx, -1, Y) + 2.0 * fx + shift(fx, 1, Y))
    return 0.25 * (shift(fy, -1, Z) + 2.0 * fy + shift(fy, 1, Z))


class DynamicSmagorinsky(AbstractClosure):
    """Scale-invariant dynamic Smagorinsky: the coefficient follows from
    the Germano identity with a 2Δ test filter, averaged over horizontal
    planes (reference ``Smagorinskys/dynamic_coefficient.jl``,
    `DynamicCoefficient` with `LagrangianAveraging`/directional averaging —
    here plane averaging, the classic Germano-Lilly form):

        c_s² = ⟨L_ij M_ij⟩ / ⟨M_ij M_ij⟩,   ν_e = c_s² Δ² √(2 S_ij S_ij)
    """

    def __init__(self, Pr=1.0, averaging_dims=(0, 1)):
        self.Pr = Pr
        self.averaging_dims = tuple(averaging_dims)

    def _collocated_strain(self, grid, u, v, w):
        dxs = grid.dx(Center, Center)
        dys = grid.dy(Center, Center)
        dzs = grid.dz(Center)
        ux = dx_c(u) / dxs
        vy = dy_c(v) / dys
        wz = dz_c(w) / dzs
        uy = ix_c(iy_c(dy_f(u))) / dys
        vx = iy_c(ix_c(dx_f(v))) / dxs
        uz = ix_c(iz_c(dz_f(u))) / dzs
        wx = iz_c(ix_c(dx_f(w))) / dxs
        vz = iy_c(iz_c(dz_f(v))) / dzs
        wy = iz_c(iy_c(dy_f(w))) / dys
        S = {(0, 0): ux, (1, 1): vy, (2, 2): wz,
             (0, 1): 0.5 * (uy + vx), (0, 2): 0.5 * (uz + wx),
             (1, 2): 0.5 * (vz + wy)}
        Smag = jnp.sqrt(2.0 * (S[(0, 0)] ** 2 + S[(1, 1)] ** 2
                               + S[(2, 2)] ** 2
                               + 2 * (S[(0, 1)] ** 2 + S[(0, 2)] ** 2
                                      + S[(1, 2)] ** 2)))
        return S, Smag

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        uc = ix_c(u)
        vc = iy_c(v)
        wc = iz_c(w)
        S, Smag = self._collocated_strain(grid, u, v, w)
        delta2 = (grid.dx(Center, Center) * grid.dy(Center, Center)
                  * grid.dz(Center)) ** (2.0 / 3.0)
        vel = {0: uc, 1: vc, 2: wc}
        LM = 0.0
        MM = 0.0
        for (i, j), Sij in S.items():
            mult = 1.0 if i == j else 2.0   # symmetric off-diagonals
            Lij = (_box_filter_ccc(vel[i] * vel[j])
                   - _box_filter_ccc(vel[i]) * _box_filter_ccc(vel[j]))
            # test-filter scale = 2Δ -> factor 4 on the filtered-scale term
            Mij = 2.0 * delta2 * (_box_filter_ccc(Smag * Sij)
                                  - 4.0 * _box_filter_ccc(Smag)
                                  * _box_filter_ccc(Sij))
            LM = LM + mult * Lij * Mij
            MM = MM + mult * Mij * Mij
        dims = self.averaging_dims
        LM_avg = jnp.mean(LM, axis=dims, keepdims=True)
        MM_avg = jnp.mean(MM, axis=dims, keepdims=True)
        cs2 = jnp.clip(-LM_avg / jnp.maximum(MM_avg, 1e-30), 0.0, 0.25)
        nu_e = cs2 * delta2 * Smag
        return {"nu_e": nu_e, "cs2": cs2}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        return _laplacian_momentum_divs(grid, diffusivities["nu_e"], u, v, w)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        Pr = _kappa_for(self.Pr, name)
        return _laplacian_tracer_div(grid, diffusivities["nu_e"] / Pr, c)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"DynamicSmagorinsky(Pr={self.Pr})"


class AnisotropicMinimumDissipation(AbstractClosure):
    """Verstappen anisotropic minimum dissipation (reference
    ``anisotropic_minimum_dissipation.jl``):

    νₑ = C max(0, −Σᵢⱼ (∂̂ᵢuⱼ)(∂̂ᵢuₖ)Sⱼₖ / Σᵢⱼ (∂ᵢuⱼ)²) with
    directionally-scaled gradients ∂̂ᵢ = Δᵢ ∂ᵢ, plus a buoyancy term.
    Gradients are collocated at centers via interpolation.
    """

    def __init__(self, C=1 / 12, Cb=0.0, Pr=None):
        self.C = float(C)
        self.Cb = float(Cb)

    def _gradients_ccc(self, grid, u, v, w):
        dxs = grid.dx(Center, Center)
        dys = grid.dy(Center, Center)
        dzs = grid.dz(Center)
        # all nine ∂ᵢuⱼ interpolated to centers
        ux = dx_c(u) / dxs
        uy = ix_c(iy_c(dy_f(u))) / dys
        uz = ix_c(iz_c(dz_f(u))) / dzs
        vx = iy_c(ix_c(dx_f(v))) / dxs
        vy = dy_c(v) / dys
        vz = iy_c(iz_c(dz_f(v))) / dzs
        wx = iz_c(ix_c(dx_f(w))) / dxs
        wy = iz_c(iy_c(dy_f(w))) / dys
        wz = dz_c(w) / dzs
        return ((ux, uy, uz), (vx, vy, vz), (wx, wy, wz)), (dxs, dys, dzs)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        grads, deltas = self._gradients_ccc(grid, u, v, w)
        (ux, uy, uz), (vx, vy, vz), (wx, wy, wz) = grads
        dxs, dys, dzs = deltas
        # gradient matrix G[j][i] = ∂ᵢ u_j ; scaled Ĝ[j][i] = Δᵢ ∂ᵢ u_j
        G = ((ux, uy, uz), (vx, vy, vz), (wx, wy, wz))
        Gh = tuple(tuple(d * g for d, g in zip((dxs, dys, dzs), row))
                   for row in G)
        S = [[0.5 * (G[j][i] + G[i][j]) for i in range(3)] for j in range(3)]
        num = 0.0
        den = 0.0
        for j in range(3):
            for k in range(3):
                acc = 0.0
                for i in range(3):
                    acc = acc + Gh[j][i] * Gh[k][i]
                num = num + acc * S[j][k]
                den = den + G[j][k] * G[j][k]
        nu_e = self.C * jnp.maximum(0.0, -num) / jnp.maximum(den, 1e-30)
        return {"nu_e": nu_e, "kappa_e": nu_e}

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        return _laplacian_momentum_divs(grid, diffusivities["nu_e"], u, v, w)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        return _laplacian_tracer_div(grid, diffusivities["kappa_e"], c)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"AnisotropicMinimumDissipation(C={self.C})"


class ConvectiveAdjustmentVerticalDiffusivity(AbstractClosure):
    """Large convective κ/ν where stratification is unstable (N² < 0),
    background values elsewhere (reference
    ``convective_adjustment_vertical_diffusivity.jl``). Vertically implicit
    by default — the convective κ is huge."""

    time_discretization = VerticallyImplicitTimeDiscretization

    def __init__(self, convective_kappa_z=1.0, convective_nu_z=0.0,
                 background_kappa_z=0.0, background_nu_z=0.0):
        self.convective_kappa_z = float(convective_kappa_z)
        self.convective_nu_z = float(convective_nu_z)
        self.background_kappa_z = float(background_kappa_z)
        self.background_nu_z = float(background_nu_z)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        from oceananigans_tpu.buoyancy import buoyancy_frequency
        N2 = buoyancy_frequency(grid, buoyancy, tracers)  # (c,c,f)
        unstable = N2 < 0.0
        kz = jnp.where(unstable, self.convective_kappa_z,
                       self.background_kappa_z)
        nz = jnp.where(unstable, self.convective_nu_z, self.background_nu_z)
        return {"kappa_z_ccf": kz, "nu_z_ccf": nz}

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        if not include_implicit and self.vertically_implicit:
            return 0.0, 0.0, 0.0
        nu = diffusivities["nu_z_ccf"]   # (c,c,f)
        fxz = ix_f(nu) * dz_f(u) / grid.dz(Face)
        fyz = iy_f(nu) * dz_f(v) / grid.dz(Face)
        fzz = iz_c(nu) * dz_c(w) / grid.dz(Center)
        zero = jnp.zeros_like(u)
        return (_div_u_fluxes(grid, zero, zero, fxz),
                _div_v_fluxes(grid, zero, zero, fyz),
                _div_w_fluxes(grid, zero, zero, fzz))

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        if not include_implicit and self.vertically_implicit:
            return jnp.zeros_like(c)
        kz = diffusivities["kappa_z_ccf"]
        fz = kz * dz_f(c) / grid.dz(Face)
        zero = jnp.zeros_like(c)
        return _div_c_fluxes(grid, zero, zero, fz)

    def vertical_nu(self, grid, diffusivities):
        return diffusivities["nu_z_ccf"]

    def vertical_kappa(self, grid, diffusivities, name):
        return diffusivities["kappa_z_ccf"]

    def __repr__(self):
        return (f"ConvectiveAdjustmentVerticalDiffusivity("
                f"κᶜ={self.convective_kappa_z}, κᵇ={self.background_kappa_z})")


# ---------------------------------------------------------------------------
# Closure tuples (reference closure_tuples.jl): models accept one closure or
# a tuple; these helpers fan over them.
# ---------------------------------------------------------------------------

def _as_tuple(closure):
    if closure is None:
        return ()
    if isinstance(closure, (tuple, list)):
        return tuple(closure)
    return (closure,)


def _max_closure_diffusivity(c, d):
    """Conservative estimate of a closure's largest diffusivity: the max
    over its computed diffusivity-field arrays plus its static nu/kappa
    coefficients. Over-estimating only makes the wizard's Δt smaller."""
    vals = []
    if d is not None:
        import jax as _jax
        for leaf in _jax.tree_util.tree_leaves(d):
            if hasattr(leaf, "ndim") and getattr(leaf, "ndim", 0) >= 1:
                vals.append(jnp.max(jnp.abs(leaf)))
    for attr in ("nu", "kappa"):
        a = getattr(c, attr, None)
        if isinstance(a, (int, float)):
            vals.append(abs(float(a)))
        elif isinstance(a, dict):
            vals.extend(abs(float(x)) for x in a.values()
                        if isinstance(x, (int, float)))
    if not vals:
        return jnp.asarray(0.0)
    out = vals[0]
    for v in vals[1:]:
        out = jnp.maximum(out, v)
    return out


def cell_diffusion_timescale(closure, grid, diffusivities=None):
    """min over closures of Δmin^p / ν_max (p = 2 Laplacian, 4
    biharmonic); reference ``src/Diagnostics/cfl.jl:33`` +
    ``cell_diffusion_timescale``. Returns +inf with no closure."""
    from oceananigans_tpu.grids.base import Center as _C, Face as _F
    sx, sy, sz = grid.interior_slices
    dmins = []
    for a in (jnp.broadcast_to(grid.dx(_F, _C), grid.shape),
              jnp.broadcast_to(grid.dy(_F, _C), grid.shape),
              jnp.broadcast_to(grid.dz(_F), grid.shape)):
        ai = a[sx, sy, sz]
        if ai.size:
            dmins.append(jnp.min(ai))
    dmin = dmins[0]
    for d in dmins[1:]:
        dmin = jnp.minimum(dmin, d)
    tau = jnp.asarray(jnp.inf)
    ds = diffusivities if diffusivities is not None \
        else (None,) * len(_as_tuple(closure))
    for c, d in zip(_as_tuple(closure), ds):
        nu_max = _max_closure_diffusivity(c, d)
        p = 4 if isinstance(c, ScalarBiharmonicDiffusivity) else 2
        tau = jnp.minimum(tau, jnp.where(nu_max > 0,
                                         dmin ** p / nu_max, jnp.inf))
    return tau


def compute_diffusivities(closure, grid, u, v, w, tracers, buoyancy,
                          top_fluxes=None):
    out = []
    for c in _as_tuple(closure):
        if getattr(c, "wants_top_fluxes", False):
            out.append(c.compute_diffusivities(grid, u, v, w, tracers,
                                               buoyancy,
                                               top_fluxes=top_fluxes))
        else:
            out.append(c.compute_diffusivities(grid, u, v, w, tracers,
                                               buoyancy))
    return tuple(out)


def momentum_flux_divergences(closure, grid, u, v, w, tracers,
                              diffusivities, include_implicit=True):
    du = dv = dw = 0.0
    for c, d in zip(_as_tuple(closure), diffusivities or ()):
        ddu, ddv, ddw = c.momentum_flux_divergences(
            grid, u, v, w, tracers, d, include_implicit=include_implicit)
        du = du + ddu
        dv = dv + ddv
        dw = dw + ddw
    return du, dv, dw


def tracer_flux_divergence(closure, grid, name, c_field, tracers,
                           diffusivities, include_implicit=True):
    out = 0.0
    for c, d in zip(_as_tuple(closure), diffusivities or ()):
        out = out + c.tracer_flux_divergence(
            grid, name, c_field, tracers, d, include_implicit=include_implicit)
    return out


def closure_is_vertically_implicit(closure):
    return any(c.vertically_implicit for c in _as_tuple(closure))


def closure_required_halo(closure):
    return max([c.required_halo() for c in _as_tuple(closure)] or [1])


# ---------------------------------------------------------------------------
# Vertically-implicit diffusion step (reference
# ``vertically_implicit_diffusion_solver.jl:38-60``): solve
# (I − Δt ∂z κ ∂z) q* = q column-wise with the batched Thomas solver.
# ---------------------------------------------------------------------------

def _implicit_step_field(grid, q, kappa_ccf, dt, lz=Center,
                         linear_ccc=None):
    """Backward-Euler vertical diffusion on one field. ``kappa_ccf`` is the
    vertical diffusivity at the z-faces bounding each cell (broadcastable).
    Operates on the full halo-extended array; only the interior Nz levels
    participate (halo levels get identity rows). ``linear_ccc``: optional
    diagonal coefficient L of an extra linear term ∂t q = L q solved
    implicitly along with the diffusion (the reference's
    ``implicit_linear_coefficient`` used by CATKE/k-ε destruction
    terms)."""
    Hz, Nz = grid.Hz, grid.Nz
    shape = grid.shape
    dzC = jnp.broadcast_to(grid.dz(Center), shape)   # cell heights
    dzF = jnp.broadcast_to(grid.dz(Face), shape)     # center-to-center
    kap = jnp.broadcast_to(kappa_ccf, shape)

    # For cell k: lower coupling through face k (kappa[k]), upper through
    # face k+1 (kappa[k+1]).
    kap_up = jnp.roll(kap, -1, axis=Z)
    dzF_up = jnp.roll(dzF, -1, axis=Z)
    lower = -dt * kap / (dzC * dzF)
    upper = -dt * kap_up / (dzC * dzF_up)

    # zero-flux at the physical boundaries: kill couplings crossing the
    # bottom wall (face Hz) and the top wall (face Hz+Nz)
    k_idx = jnp.arange(shape[Z]).reshape(1, 1, -1)
    in_interior = (k_idx >= Hz) & (k_idx < Hz + Nz)
    lower = jnp.where((k_idx > Hz) & in_interior, lower, 0.0)
    upper = jnp.where((k_idx < Hz + Nz - 1) & in_interior, upper, 0.0)
    diag = 1.0 - lower - upper
    if linear_ccc is not None:
        L = jnp.broadcast_to(linear_ccc, shape)
        diag = diag - dt * jnp.where(in_interior, L, 0.0)
    return tridiagonal_solve(lower, diag, upper, q, axis=Z)


def implicit_vertical_diffusion_step(grid, closure, diffusivities, dt,
                                     u=None, v=None, tracers=None):
    """Apply the implicit vertical-diffusion solve to velocities/tracers for
    every vertically-implicit closure. Returns updated (u, v, tracers)."""
    for c, d in zip(_as_tuple(closure), diffusivities or ()):
        if not c.vertically_implicit:
            continue
        nu = c.vertical_nu(grid, d)
        if u is not None and not _is_zero(nu):
            u = _implicit_step_field(grid, u, _face_z(nu), dt)
            v = _implicit_step_field(grid, v, _face_z(nu), dt)
        if tracers is not None:
            lin_of = getattr(c, "implicit_linear_coefficient", None)
            new_tracers = {}
            for name, cf in tracers.items():
                kap = c.vertical_kappa(grid, d, name)
                lin = lin_of(grid, d, name) if lin_of is not None else None
                if _is_zero(kap) and lin is None:
                    new_tracers[name] = cf
                else:
                    new_tracers[name] = _implicit_step_field(
                        grid, cf, _face_z(kap), dt, linear_ccc=lin)
            tracers = new_tracers
    return u, v, tracers


def _is_zero(x):
    return isinstance(x, (int, float)) and x == 0.0


def _face_z(kappa):
    """Coefficient already lives at z-faces for CAVD; scalars pass through."""
    return kappa


# ---------------------------------------------------------------------------
# Reference constructor-name parity
# ---------------------------------------------------------------------------

def VerticalScalarBiharmonicDiffusivity(nu=0.0, kappa=0.0):
    """Biharmonic fluxes in z only (reference
    ``scalar_biharmonic_diffusivity.jl`` ``VerticalScalarBiharmonicDiffusivity``)."""
    return ScalarBiharmonicDiffusivity(nu=nu, kappa=kappa,
                                       isotropy="vertical")


def HorizontalScalarBiharmonicDiffusivity(nu=0.0, kappa=0.0):
    """Biharmonic fluxes in (x, y) only — the standard mesoscale
    hyperviscosity (reference ``HorizontalScalarBiharmonicDiffusivity``)."""
    return ScalarBiharmonicDiffusivity(nu=nu, kappa=kappa,
                                       isotropy="horizontal")


class LillyCoefficient:
    """Constant Smagorinsky coefficient with Lilly's buoyancy modification
    (reference ``Smagorinskys/lilly_coefficient.jl``)."""

    def __init__(self, smagorinsky=0.16, reduction_factor=1.0):
        self.smagorinsky = float(smagorinsky)
        self.reduction_factor = float(reduction_factor)


class DynamicCoefficient:
    """Germano-identity dynamic coefficient, averaged over ``dims``
    (reference ``Smagorinskys/dynamic_coefficient.jl``; here the classic
    plane-averaged Germano-Lilly form)."""

    def __init__(self, averaging=(0, 1)):
        if isinstance(averaging, int):
            averaging = (averaging,)
        self.averaging = tuple(averaging)


def Smagorinsky(coefficient=None, Cb=1.0, Pr=1.0):
    """Reference ``Smagorinsky(; coefficient, Pr)``: dispatches on the
    coefficient type — a number or :class:`LillyCoefficient` gives the
    static :class:`SmagorinskyLilly`, a :class:`DynamicCoefficient` the
    Germano-identity :class:`DynamicSmagorinsky`."""
    if coefficient is None:
        coefficient = LillyCoefficient()
    if isinstance(coefficient, DynamicCoefficient):
        return DynamicSmagorinsky(Pr=Pr, averaging_dims=coefficient.averaging)
    if isinstance(coefficient, LillyCoefficient):
        return SmagorinskyLilly(C=coefficient.smagorinsky,
                                Cb=Cb * coefficient.reduction_factor, Pr=Pr)
    return SmagorinskyLilly(C=float(coefficient), Cb=Cb, Pr=Pr)


def viscosity(closure, diffusivities):
    """The closure's eddy (or molecular) viscosity — reference
    ``viscosity(closure, diffusivity_fields)``. Returns a number or a
    whole-array field depending on the closure."""
    if isinstance(closure, (tuple, list)):
        return tuple(viscosity(c, d)
                     for c, d in zip(closure, diffusivities))
    if diffusivities:
        for key in ("nu_e", "nu_z_ccf"):
            if key in diffusivities:
                return diffusivities[key]
    return getattr(closure, "nu", 0.0)


def diffusivity(closure, diffusivities, name=None):
    """The closure's tracer diffusivity (reference
    ``diffusivity(closure, diffusivity_fields, ::Val{name})``)."""
    if isinstance(closure, (tuple, list)):
        return tuple(diffusivity(c, d, name)
                     for c, d in zip(closure, diffusivities))
    if diffusivities:
        for key in ("kappa_e", "kappa_e_ccf", "kappa_z_ccf"):
            if key in diffusivities:
                return diffusivities[key]
        if "nu_e" in diffusivities:   # Pr-scaled LES closures
            Pr = _kappa_for(getattr(closure, "Pr", 1.0), name) or 1.0
            return diffusivities["nu_e"] / Pr
    return _kappa_for(getattr(closure, "kappa", 0.0), name)
