"""Ocean boundary-layer and mesoscale closures: CATKE, Ri-based, Leith,
isopycnal (GM/Redi).

Reference: ``src/TurbulenceClosures/turbulence_closure_implementations/``
(SURVEY.md §2.13) — ``TKEBasedVerticalDiffusivities/`` (CATKE, 9 files),
``ri_based_vertical_diffusivity.jl``, ``leith_enstrophy_diffusivity.jl``,
``isopycnal_skew_symmetric_diffusivity.jl`` +
``isopycnal_rotation_tensor_components.jl``.

These are compact whole-array implementations of the same closure physics:
everything is a branch-free array expression; the vertical-implicit path
reuses the batched Thomas solver.
"""

from __future__ import annotations

import jax.numpy as jnp

from oceananigans_tpu.closures import (
    AbstractClosure, VerticallyImplicitTimeDiscretization,
    _div_c_fluxes, _div_u_fluxes, _div_v_fluxes, _div_w_fluxes,
)
from oceananigans_tpu.grids.base import Center, Face
from oceananigans_tpu.ops.operators import (
    dx_f, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c, iy_f, iz_c, iz_f, shift,
)

__all__ = ["CATKEVerticalDiffusivity", "CATKEMixingLength",
           "CATKEEquation", "RiBasedVerticalDiffusivity",
           "LeithEnstrophyDiffusivity", "IsopycnalSkewSymmetricDiffusivity",
           "TKEDissipationVerticalDiffusivity"]


def _shear_squared_ccf(grid, u, v):
    """|∂z u|² at (c,c,f)."""
    uz = ix_c(dz_f(u)) / grid.dz(Face)
    vz = iy_c(dz_f(v)) / grid.dz(Face)
    return uz * uz + vz * vz


def _richardson_ccf(grid, u, v, tracers, buoyancy):
    from oceananigans_tpu.buoyancy import buoyancy_frequency
    N2 = buoyancy_frequency(grid, buoyancy, tracers)
    S2 = _shear_squared_ccf(grid, u, v)
    return N2 / jnp.maximum(S2, 1e-14)


class RiBasedVerticalDiffusivity(AbstractClosure):
    """Richardson-number-dependent vertical ν/κ (reference
    ``ri_based_vertical_diffusivity.jl``):

    κ = κ₀ · step(Ri) + κᶜᵃ · (N² < 0), with a smooth tanh step
    ``step(Ri) = (1 − tanh((Ri − Ri₀)/δ))/2`` clamped to [0, 1].
    """

    time_discretization = VerticallyImplicitTimeDiscretization

    def __init__(self, nu_0=0.7, kappa_0=0.5, Ri_0=0.1, Ri_delta=0.4,
                 convective_kappa=1.0, minimum_kappa=1e-5):
        self.nu_0 = float(nu_0)
        self.kappa_0 = float(kappa_0)
        self.Ri_0 = float(Ri_0)
        self.Ri_delta = float(Ri_delta)
        self.convective_kappa = float(convective_kappa)
        self.minimum_kappa = float(minimum_kappa)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        from oceananigans_tpu.buoyancy import buoyancy_frequency
        Ri = _richardson_ccf(grid, u, v, tracers, buoyancy)
        N2 = buoyancy_frequency(grid, buoyancy, tracers)
        step = 0.5 * (1.0 - jnp.tanh((Ri - self.Ri_0) / self.Ri_delta))
        conv = jnp.where(N2 < 0, self.convective_kappa, 0.0)
        kappa = self.kappa_0 * step + conv + self.minimum_kappa
        nu = self.nu_0 * step + conv + self.minimum_kappa
        return {"kappa_z_ccf": kappa, "nu_z_ccf": nu}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        if not include_implicit:
            return 0.0, 0.0, 0.0
        nu = diffusivities["nu_z_ccf"]
        fxz = ix_f(nu) * dz_f(u) / grid.dz(Face)
        fyz = iy_f(nu) * dz_f(v) / grid.dz(Face)
        fzz = iz_c(nu) * dz_c(w) / grid.dz(Center)
        zero = jnp.zeros_like(u)
        return (_div_u_fluxes(grid, zero, zero, fxz),
                _div_v_fluxes(grid, zero, zero, fyz),
                _div_w_fluxes(grid, zero, zero, fzz))

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        if not include_implicit:
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
        return (f"RiBasedVerticalDiffusivity(ν₀={self.nu_0}, "
                f"κ₀={self.kappa_0})")


import dataclasses


@dataclasses.dataclass(frozen=True)
class CATKEMixingLength:
    """Mixing-length parameters (reference ``catke_mixing_length.jl:15-37``,
    same names romanized, same calibrated defaults)."""
    Cs: float = 1.131     # surface distance coefficient
    Cb: float = 0.28      # bottom distance coefficient
    Csp: float = 0.505    # sheared convective plume coefficient
    CRi_delta: float = 1.02   # stability function width
    CRi0: float = 0.254       # stability function lower Ri
    Chi_u: float = 0.242
    Clo_u: float = 0.361
    Cun_u: float = 0.370
    Cc_u: float = 3.705
    Ce_u: float = 0.0
    Chi_c: float = 0.098
    Clo_c: float = 0.369
    Cun_c: float = 0.572
    Cc_c: float = 4.793
    Ce_c: float = 0.112
    Chi_e: float = 0.548
    Clo_e: float = 7.863
    Cun_e: float = 1.447
    Cc_e: float = 3.642
    Ce_e: float = 0.0


@dataclasses.dataclass(frozen=True)
class CATKEEquation:
    """TKE-equation parameters (reference ``catke_equation.jl:7-17``)."""
    Chi_D: float = 0.579
    Clo_D: float = 1.604
    Cun_D: float = 0.923
    Cc_D: float = 3.254
    Ce_D: float = 0.0
    CW_ustar: float = 3.179   # surface shear-driven TKE flux coefficient
    CW_wdelta: float = 0.383  # surface convective TKE flux coefficient
    CW_eps: float = 1.0


class CATKEVerticalDiffusivity(AbstractClosure):
    """CATKE: prognostic-TKE vertical closure with the reference's FULL
    mixing-length formulation (``catke_vertical_diffusivity.jl``,
    ``catke_mixing_length.jl``, ``catke_equation.jl``):

    - per-quantity stability functions σ(Ri) (piecewise-linear between
      the unstable, low-Ri, and high-Ri coefficients),
    - stable length ℓ★ = σ · min(Cˢ·depth, Cᵇ·height-above-bottom,
      w★/√N²⁺),
    - convective (Deardorff) and entrainment lengths driven by the
      surface buoyancy flux Jᵇ with the sheared-convection reduction,
    - dissipation ε = ω e with ω = √e/ℓᴰ (its own coefficient set) and
      fast damping of negative e,
    - surface TKE flux J_e = −(Cᵂu★ u★³ + CᵂwΔ wΔ³) from the momentum
      and buoyancy surface fluxes.

    The models pass the top flux-BC values via ``top_fluxes``; without
    them the convective/entrainment machinery reduces to zero (pure
    shear turbulence), matching the reference with no surface forcing.
    """

    time_discretization = VerticallyImplicitTimeDiscretization
    required_tracers = ("e",)
    wants_top_fluxes = True

    def __init__(self, mixing_length=None, tke_equation=None,
                 maximum_viscosity=float("inf"),
                 maximum_tracer_diffusivity=float("inf"),
                 minimum_tke=1e-9,
                 minimum_convective_buoyancy_flux=1e-11,
                 negative_tke_damping_time_scale=60.0):
        self.mixing_length = mixing_length or CATKEMixingLength()
        self.tke_equation = tke_equation or CATKEEquation()
        self.maximum_viscosity = float(maximum_viscosity)
        self.maximum_tracer_diffusivity = float(maximum_tracer_diffusivity)
        self.minimum_tke = float(minimum_tke)
        self.Jb_eps = float(minimum_convective_buoyancy_flux)
        self.neg_damping = float(negative_tke_damping_time_scale)

    # ------------------------------------------------------------------
    def _sigma(self, Ri, Cun, Clo, Chi):
        """σ(Ri): Cun for Ri<0; for Ri>=0, Clo → Chi over the step
        [CRi0, CRi0+CRiδ] (reference ``scale``/``step``)."""
        ml = self.mixing_length
        t = jnp.clip((Ri - ml.CRi0) / ml.CRi_delta, 0.0, 1.0)
        sp = Clo + (Chi - Clo) * t
        return jnp.where(Ri < 0, Cun, sp)

    def _stable_length(self, sigma, w_star, N2, d_up, d_down):
        big = jnp.asarray(1e20, w_star.dtype)
        lN = jnp.where(N2 > 0, w_star / jnp.sqrt(jnp.maximum(N2, 1e-30)),
                       big)
        d = jnp.minimum(d_up, d_down)
        return sigma * jnp.minimum(d, lN)

    def _convective_length(self, Cc, Ce, w_star, S2, N2, N2_above, Jb,
                           depth):
        ml = self.mixing_length
        Jb_tot = Jb + self.Jb_eps
        lc = Cc * w_star ** 3 / Jb_tot
        Rif = depth * w_star * S2 / Jb_tot    # flux Richardson number
        lc = jnp.maximum((1.0 - ml.Csp * Rif) * lc, 0.0)
        le = Ce * Jb / (w_star * N2 + self.Jb_eps)
        convecting = (Jb > self.Jb_eps) & (N2 < 0)
        entraining = (Jb > self.Jb_eps) & (N2 > 0) & (N2_above < 0)
        return jnp.where(convecting, lc,
                         jnp.where(entraining, le, 0.0))

    def _lengths_at(self, grid, e_loc, N2, S2, Ri, Jb, z, coeffs):
        """Mixing length for one quantity at one vertical location.
        ``coeffs`` = (Cun, Clo, Chi, Cc, Ce)."""
        Cun, Clo, Chi, Cc, Ce = coeffs
        ml = self.mixing_length
        w_star = jnp.sqrt(jnp.maximum(e_loc, 0.0))
        depth = jnp.maximum(-z, 0.0)                  # surface at z = 0
        habove = jnp.maximum(z + grid.Lz, 0.0)
        sigma = self._sigma(Ri, Cun, Clo, Chi)
        l_star = self._stable_length(sigma, w_star, N2,
                                     ml.Cs * depth, ml.Cb * habove)
        N2_above = shift(N2, 1, 2)
        lh = self._convective_length(Cc, Ce, w_star, S2, N2, N2_above,
                                     Jb, depth)
        return jnp.minimum(grid.Lz, jnp.maximum(l_star, lh))

    # ------------------------------------------------------------------
    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy,
                              top_fluxes=None):
        from oceananigans_tpu.buoyancy import buoyancy_frequency
        top_fluxes = top_fluxes or {}
        e = tracers["e"]
        e_ccf = iz_f(e)
        N2_ccf = (buoyancy_frequency(grid, buoyancy, tracers)
                  if buoyancy is not None else jnp.zeros_like(e_ccf))
        S2_ccf = _shear_squared_ccf(grid, u, v)
        Ri_ccf = N2_ccf / jnp.maximum(S2_ccf, 1e-20)
        Jb = top_fluxes.get("b")
        Jb = jnp.zeros((), e.dtype) if Jb is None else jnp.asarray(Jb)
        Jb = jnp.maximum(Jb, 0.0)      # only destabilizing flux convects

        ml = self.mixing_length
        zF = jnp.broadcast_to(grid.zF, grid.shape)
        ell_u = self._lengths_at(grid, e_ccf, N2_ccf, S2_ccf, Ri_ccf, Jb,
                                 zF, (ml.Cun_u, ml.Clo_u, ml.Chi_u,
                                      ml.Cc_u, ml.Ce_u))
        ell_c = self._lengths_at(grid, e_ccf, N2_ccf, S2_ccf, Ri_ccf, Jb,
                                 zF, (ml.Cun_c, ml.Clo_c, ml.Chi_c,
                                      ml.Cc_c, ml.Ce_c))
        ell_e = self._lengths_at(grid, e_ccf, N2_ccf, S2_ccf, Ri_ccf, Jb,
                                 zF, (ml.Cun_e, ml.Clo_e, ml.Chi_e,
                                      ml.Cc_e, ml.Ce_e))
        w_star_ccf = jnp.sqrt(jnp.maximum(e_ccf, self.minimum_tke))
        ku = jnp.minimum(ell_u * w_star_ccf, self.maximum_viscosity)
        kc = jnp.minimum(ell_c * w_star_ccf,
                         self.maximum_tracer_diffusivity)
        ke = jnp.minimum(ell_e * w_star_ccf,
                         self.maximum_tracer_diffusivity)

        # dissipation rate at cell centers (its own coefficient set)
        te = self.tke_equation
        N2_ccc = iz_c(N2_ccf)
        S2_ccc = iz_c(S2_ccf)
        Ri_ccc = N2_ccc / jnp.maximum(S2_ccc, 1e-20)
        zC = jnp.broadcast_to(grid.zC, grid.shape)
        # the dissipation stability function DIVIDES the stable length
        # (reference ``dissipation_length_scaleᶜᶜᶜ``: ℓ★ = ℓ★/σᴰ)
        sigma_D = self._sigma(Ri_ccc, te.Cun_D, te.Clo_D, te.Chi_D)
        w_star_ccc = jnp.sqrt(jnp.maximum(e, 0.0))
        depth_c = jnp.maximum(-zC, 0.0)
        habove_c = jnp.maximum(zC + grid.Lz, 0.0)
        l_star_D = self._stable_length(1.0 / sigma_D, w_star_ccc, N2_ccc,
                                       ml.Cs * depth_c,
                                       ml.Cb * habove_c)
        lh_D = self._convective_length(te.Cc_D, te.Ce_D, w_star_ccc,
                                       S2_ccc, N2_ccc,
                                       shift(N2_ccc, 1, 2), Jb, depth_c)
        ell_D = jnp.minimum(grid.Lz, jnp.maximum(l_star_D, lh_D))
        omega = jnp.where(
            e < 0, 1.0 / self.neg_damping,
            jnp.sqrt(jnp.abs(e)) / jnp.maximum(ell_D, 1e-10))

        # surface TKE flux from the momentum/buoyancy surface fluxes
        tau_x = top_fluxes.get("u")
        tau_y = top_fluxes.get("v")
        zero2d = jnp.zeros((), e.dtype)
        tx = zero2d if tau_x is None else jnp.asarray(tau_x)
        ty = zero2d if tau_y is None else jnp.asarray(tau_y)
        u_star = (tx ** 2 + ty ** 2) ** 0.25
        dz_top = jnp.asarray(grid.dz(Center)).reshape(-1)[grid.Hz
                                                          + grid.Nz - 1]
        wdelta3 = jnp.maximum(Jb, 0.0) * dz_top
        J_e = -(te.CW_ustar * u_star ** 3 + te.CW_wdelta * wdelta3)

        # linear implicit coefficient Le of ∂t e = Le·e + ... (reference
        # time_step_catke_equation.jl:110-145): the dissipation −ω e and
        # the DESTABILIZING part of the buoyancy flux wb⁻ go into the
        # diagonal of the vertically-implicit solve (Patankar split), so
        # large Δt cannot drive e negative through explicit destruction
        k_idx = jnp.arange(grid.shape[2]).reshape(1, 1, -1)
        in_faces = (k_idx > grid.Hz) & (k_idx < grid.Hz + grid.Nz)
        wb_ccf = jnp.where(in_faces, -kc * N2_ccf, 0.0)
        wb_minus = iz_c(jnp.minimum(wb_ccf, 0.0))
        Le = wb_minus / jnp.maximum(e, self.minimum_tke) - omega

        return {"nu_z_ccf": ku, "kappa_z_ccf": kc, "kappa_e_ccf": ke,
                "mixing_length_ccf": ell_u, "N2_ccf": N2_ccf,
                "shear_production_ccf": ku * S2_ccf,
                "dissipation_rate_ccc": omega, "Le_ccc": Le,
                "tke_top_flux": J_e, "dz_top": dz_top}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        if not include_implicit:
            return 0.0, 0.0, 0.0
        nu = diffusivities["nu_z_ccf"]
        fxz = ix_f(nu) * dz_f(u) / grid.dz(Face)
        fyz = iy_f(nu) * dz_f(v) / grid.dz(Face)
        zero = jnp.zeros_like(u)
        return (_div_u_fluxes(grid, zero, zero, fxz),
                _div_v_fluxes(grid, zero, zero, fyz),
                jnp.zeros_like(w))

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        e = tracers["e"]
        if name == "e":
            kc = diffusivities["kappa_z_ccf"]
            N2 = diffusivities["N2_ccf"]
            P = diffusivities["shear_production_ccf"]
            # explicit sources: shear production + the STABILIZING part
            # of the buoyancy flux; dissipation and destabilizing wb are
            # handled implicitly via Le_ccc (reference Patankar split,
            # time_step_catke_equation.jl:110-145)
            wb = jnp.maximum(-kc * N2, 0.0)
            k_idx = jnp.arange(grid.shape[2]).reshape(1, 1, -1)
            in_faces = (k_idx > grid.Hz) & (k_idx < grid.Hz + grid.Nz)
            source_ccf = jnp.where(in_faces, P + wb, 0.0)
            src = iz_c(source_ccf)
            # surface TKE injection into the top interior cell
            J_e = diffusivities["tke_top_flux"]
            dz_top = diffusivities["dz_top"]
            top_cell = (k_idx == grid.Hz + grid.Nz - 1)
            src = src + jnp.where(top_cell, -J_e / dz_top, 0.0)
            return src
        if not include_implicit:
            return jnp.zeros_like(c)
        kz = diffusivities["kappa_z_ccf"]
        fz = kz * dz_f(c) / grid.dz(Face)
        zero = jnp.zeros_like(c)
        return _div_c_fluxes(grid, zero, zero, fz)

    def implicit_linear_coefficient(self, grid, diffusivities, name):
        """Diagonal L of ∂t e = L e + ... (dissipation + destabilizing
        buoyancy flux), solved implicitly with the vertical diffusion
        (reference time_step_catke_equation.jl:110-145)."""
        if name == "e":
            return diffusivities["Le_ccc"]
        return None

    def vertical_nu(self, grid, diffusivities):
        return diffusivities["nu_z_ccf"]

    def vertical_kappa(self, grid, diffusivities, name):
        if name == "e":
            return diffusivities["kappa_e_ccf"]
        return diffusivities["kappa_z_ccf"]

    def __repr__(self):
        return "CATKEVerticalDiffusivity(reference coefficient set)"


class VariableStabilityFunctions:
    """Umlauf & Burchard (2005) second-order stability functions for k-ε
    (reference ``tke_dissipation_stability_functions.jl``
    ``VariableStabilityFunctions``): 𝕊(αᴺ, αᴹ) rational functions of the
    stratification number αᴺ = τ²N² and shear number αᴹ = τ²S², with the
    realizability clamps (free-convection minimum αᴺ scaled by a safety
    factor, and the shear-anisotropy maximum αᴹ(αᴺ))."""

    def __init__(self, Csigma_e=1.0, Csigma_eps=1.2,
                 Cu0=0.1067, Cu1=0.0173, Cu2=-0.0001205,
                 Cc0=0.1120, Cc1=0.003766, Cc2=0.0008871,
                 Cd0=1.0, Cd1=0.2398, Cd2=0.02872, Cd3=0.005154,
                 Cd4=0.006930, Cd5=-0.0003372, Su0=None):
        self.Csigma_e = float(Csigma_e)
        self.Csigma_eps = float(Csigma_eps)
        self.Cu0, self.Cu1, self.Cu2 = float(Cu0), float(Cu1), float(Cu2)
        self.Cc0, self.Cc1, self.Cc2 = float(Cc0), float(Cc1), float(Cc2)
        self.Cd0, self.Cd1, self.Cd2 = float(Cd0), float(Cd1), float(Cd2)
        self.Cd3, self.Cd4, self.Cd5 = float(Cd3), float(Cd4), float(Cd5)
        if Su0 is None:
            # log-layer equilibrium (production = dissipation), Umlauf &
            # Burchard (2003) eq. (13) discussion
            import math
            a = self.Cd5 - self.Cu2
            b = self.Cd2 - self.Cu0
            c = self.Cd0
            Su0 = (2 * a / (-b - math.sqrt(b * b - 4 * a * c))) ** 0.25
        self.Su0 = float(Su0)

    def minimum_stratification_number(self, safety):
        """Free-convection realizability bound (Umlauf & Burchard 2005
        eq. A.22), reduced by the safety factor."""
        import math
        a = self.Cd4 + self.Cc1
        b = self.Cd1 + self.Cc0
        c = self.Cd0
        return safety * (-b + math.sqrt(b * b - 4 * a * c)) / (2 * a)

    def maximum_shear_number(self, aN):
        """Shear-anisotropy bound αᴹmax(αᴺ) (Umlauf & Burchard 2005
        eq. 44)."""
        n0, n1 = self.Cu0, self.Cu1
        d0, d1, d2, d3, d4 = (self.Cd0, self.Cd1, self.Cd2, self.Cd3,
                              self.Cd4)
        e0 = d0 * n0
        e1 = d0 * n1 + d1 * n0
        e2 = d1 * n1 + d4 * n0
        e3 = d4 * n1
        e4 = d2 * n0
        e5 = d2 * n1 + d3 * n0
        e6 = d3 * n1
        num = e0 + e1 * aN + e2 * aN ** 2 + e3 * aN ** 3
        den = e4 + e5 * aN + e6 * aN ** 2
        return num / den

    def momentum_and_tracer(self, aN, aM):
        den = (self.Cd0 + self.Cd1 * aN + self.Cd2 * aM
               + self.Cd3 * aN * aM + self.Cd4 * aN ** 2
               + self.Cd5 * aM ** 2)
        Su = (self.Cu0 + self.Cu1 * aN + self.Cu2 * aM) / den
        Sc = (self.Cc0 + self.Cc1 * aN + self.Cc2 * aM) / den
        return Su, Sc

    def __repr__(self):
        return "VariableStabilityFunctions()"


class TKEDissipationVerticalDiffusivity(AbstractClosure):
    """k-ε vertical closure: two prognostic tracers — TKE ``e`` and its
    dissipation rate ``eps`` (reference
    ``TKEBasedVerticalDiffusivities/tke_dissipation_vertical_diffusivity.jl``
    + ``tke_dissipation_equations.jl``; Umlauf & Burchard 2003/2005,
    Burchard & Bolding 2001).

    Reference-fidelity formulation:
      - diffusivities κ(u,c,e,ε) = 𝕊 e★²/ε★ at (c,c,f) with the
        ``VariableStabilityFunctions`` 𝕊(αᴺ, αᴹ) (realizability-clamped);
      - dissipation floored by the stratified displacement scale
        ℓst = Cᴺ √(e★/N²⁺): ε ≥ 𝕊u₀³ e★^{3/2} / min(Lz, ℓst)
        (``StratifiedDisplacementScale``, ``minimum_dissipation``);
      - sources split Patankar-style (``substep_tke_dissipation!``):
        positive parts (P + wb⁺; ωϵ(Cᴾϵ P + [Cᵇϵ wb]⁺)) are explicit
        tendencies, the destruction terms enter the vertically-implicit
        solve as linear diagonal coefficients
        Le = wb⁻/e − ωe, Lϵ = [Cᵇϵ wb]⁻/e★ − Cᵋϵ ωϵ
        (``implicit_linear_coefficient``), with negative-TKE damping on
        the ωe time scale.
    """

    time_discretization = VerticallyImplicitTimeDiscretization
    required_tracers = ("e", "eps")

    def __init__(self, Ceps_eps=1.92, Cp_eps=1.44,
                 Cb_eps_stable=-0.65, Cb_eps_unstable=-0.65,
                 stability_functions=None,
                 Cn_length=0.75, minimum_N2=1e-14,
                 stratification_number_safety_factor=0.73,
                 maximum_viscosity=float("inf"),
                 maximum_tracer_diffusivity=float("inf"),
                 maximum_tke_diffusivity=float("inf"),
                 maximum_dissipation_diffusivity=float("inf"),
                 minimum_tke=1e-6, minimum_eps=1e-12,
                 negative_tke_damping_time_scale=60.0):
        self.Ceps_eps = float(Ceps_eps)       # Cᵋϵ
        self.Cp_eps = float(Cp_eps)           # Cᴾϵ
        self.Cb_eps_stable = float(Cb_eps_stable)
        self.Cb_eps_unstable = float(Cb_eps_unstable)
        self.stability_functions = (stability_functions
                                    or VariableStabilityFunctions())
        self.Cn_length = float(Cn_length)     # StratifiedDisplacementScale
        self.minimum_N2 = float(minimum_N2)
        self.safety = float(stratification_number_safety_factor)
        self.maximum_viscosity = float(maximum_viscosity)
        self.maximum_tracer_diffusivity = float(maximum_tracer_diffusivity)
        self.maximum_tke_diffusivity = float(maximum_tke_diffusivity)
        self.maximum_dissipation_diffusivity = float(
            maximum_dissipation_diffusivity)
        self.minimum_tke = float(minimum_tke)
        self.minimum_eps = float(minimum_eps)
        self.neg_damping = float(negative_tke_damping_time_scale)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        from oceananigans_tpu.buoyancy import buoyancy_frequency
        sf = self.stability_functions
        e_raw = tracers["e"]
        eps_raw = tracers["eps"]
        e_star = jnp.maximum(e_raw, self.minimum_tke)

        N2_ccf = (buoyancy_frequency(grid, buoyancy, tracers)
                  if buoyancy is not None else jnp.zeros_like(e_raw))
        S2_ccf = _shear_squared_ccf(grid, u, v)

        # stratified displacement dissipation floor (minimum_dissipation)
        N2p_ccc = iz_c(jnp.maximum(N2_ccf, self.minimum_N2))
        l_st = self.Cn_length * jnp.sqrt(e_star / N2p_ccc)
        l_min = jnp.minimum(grid.Lz, l_st)
        eps_floor = jnp.maximum(
            self.minimum_eps, sf.Su0 ** 3 * e_star ** 1.5 / l_min)
        eps_star = jnp.maximum(eps_raw, eps_floor)

        # stability functions on the realizability-clamped numbers
        tau2_ccf = iz_f((e_star / eps_star) ** 2)
        aN_min = sf.minimum_stratification_number(self.safety)
        aN = jnp.clip(tau2_ccf * N2_ccf, aN_min, 1e10)
        aM = jnp.clip(tau2_ccf * S2_ccf, 0.0, sf.maximum_shear_number(aN))
        Su, Sc = sf.momentum_and_tracer(aN, aM)

        e2_over_eps = iz_f(e_star ** 2) / iz_f(eps_star)
        ku = jnp.minimum(Su * e2_over_eps, self.maximum_viscosity)
        kc = jnp.minimum(Sc * e2_over_eps,
                         self.maximum_tracer_diffusivity)
        ke = jnp.minimum(Su / sf.Csigma_e * e2_over_eps,
                         self.maximum_tke_diffusivity)
        keps = jnp.minimum(Su / sf.Csigma_eps * e2_over_eps,
                           self.maximum_dissipation_diffusivity)

        # source ingredients at centers (interior z-faces only)
        mask = self._interior_faces_mask(grid)
        P_ccc = iz_c(jnp.where(mask, ku * S2_ccf, 0.0))
        wb_ccc = -iz_c(jnp.where(mask, kc * N2_ccf, 0.0))
        omega_e = jnp.where(e_raw < 0, 1.0 / self.neg_damping,
                            eps_star / e_star)
        omega_eps = eps_raw / e_star
        N2_ccc = iz_c(N2_ccf)
        Cb = jnp.where(N2_ccc >= 0, self.Cb_eps_stable,
                       self.Cb_eps_unstable)
        Cb_wb = Cb * wb_ccc
        wb_minus_over_e = jnp.where(
            e_raw > self.minimum_tke,
            jnp.minimum(wb_ccc, 0.0) / jnp.where(e_raw > self.minimum_tke,
                                                 e_raw, 1.0), 0.0)

        return {"nu_z_ccf": ku, "kappa_z_ccf": kc,
                "kappa_e_ccf": ke, "kappa_eps_ccf": keps,
                "P_ccc": P_ccc, "wb_ccc": wb_ccc,
                "Le_ccc": wb_minus_over_e - omega_e,
                "Leps_ccc": (jnp.minimum(Cb_wb, 0.0) / e_star
                             - self.Ceps_eps * omega_eps),
                "Ge_fast_ccc": P_ccc + jnp.maximum(wb_ccc, 0.0),
                "Geps_fast_ccc": omega_eps * (self.Cp_eps * P_ccc
                                              + jnp.maximum(Cb_wb, 0.0)),
                "N2_ccf": N2_ccf}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        if not include_implicit:
            return 0.0, 0.0, 0.0
        nu = diffusivities["nu_z_ccf"]
        fxz = ix_f(nu) * dz_f(u) / grid.dz(Face)
        fyz = iy_f(nu) * dz_f(v) / grid.dz(Face)
        zero = jnp.zeros_like(u)
        return (_div_u_fluxes(grid, zero, zero, fxz),
                _div_v_fluxes(grid, zero, zero, fyz),
                jnp.zeros_like(w))

    def _interior_faces_mask(self, grid):
        k = jnp.arange(grid.shape[2]).reshape(1, 1, -1)
        return (k > grid.Hz) & (k < grid.Hz + grid.Nz)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        if name == "e":
            # fast/positive sources only; destruction is in the linear
            # implicit coefficient (reference substep_tke_dissipation!)
            return diffusivities["Ge_fast_ccc"]
        if name == "eps":
            return diffusivities["Geps_fast_ccc"]
        if not include_implicit:
            return jnp.zeros_like(c)
        kz = diffusivities["kappa_z_ccf"]
        fz = kz * dz_f(c) / grid.dz(Face)
        zero = jnp.zeros_like(c)
        return _div_c_fluxes(grid, zero, zero, fz)

    def implicit_linear_coefficient(self, grid, diffusivities, name):
        """Diagonal L of ∂t q = L q + ..., solved implicitly along with
        the vertical diffusion (reference
        ``implicit_linear_coefficient``/``Le``/``Lϵ``)."""
        if name == "e":
            return diffusivities["Le_ccc"]
        if name == "eps":
            return diffusivities["Leps_ccc"]
        return None

    def vertical_nu(self, grid, diffusivities):
        return diffusivities["nu_z_ccf"]

    def vertical_kappa(self, grid, diffusivities, name):
        if name == "e":
            return diffusivities["kappa_e_ccf"]
        if name == "eps":
            return diffusivities["kappa_eps_ccf"]
        return diffusivities["kappa_z_ccf"]

    def __repr__(self):
        return "TKEDissipationVerticalDiffusivity(k-epsilon, " \
               "variable stability functions)"


class LeithEnstrophyDiffusivity(AbstractClosure):
    """2-D Leith horizontal eddy viscosity ν = (C Δ/π)³ |∇ζ| (reference
    ``leith_enstrophy_diffusivity.jl``)."""

    def __init__(self, C=1.0):
        self.C = float(C)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        from oceananigans_tpu.ops.operators import vorticity_z_ff
        zeta = vorticity_z_ff(grid, u, v)
        dzx = ix_c(dx_f(iy_c(zeta))) / grid.dx(Center, Center)
        dzy = iy_c(dy_f(ix_c(zeta))) / grid.dy(Center, Center)
        grad_z = jnp.sqrt(dzx * dzx + dzy * dzy)
        delta = jnp.sqrt(grid.dx(Center, Center) * grid.dy(Center, Center))
        nu = (self.C * delta / jnp.pi) ** 3 * grad_z
        return {"nu_e": nu}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        from oceananigans_tpu.closures import _laplacian_momentum_divs
        return _laplacian_momentum_divs(grid, diffusivities["nu_e"], u, v, w,
                                        include_z=False)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        from oceananigans_tpu.closures import _laplacian_tracer_div
        return _laplacian_tracer_div(grid, diffusivities["nu_e"], c,
                                     include_z=False)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"LeithEnstrophyDiffusivity(C={self.C})"


class IsopycnalSkewSymmetricDiffusivity(AbstractClosure):
    """Gent-McWilliams + Redi: along-isopycnal tracer diffusion (symmetric,
    κ_R) and eddy-induced skew flux (antisymmetric, κ_GM) in the small-
    slope approximation with slope clipping (reference
    ``isopycnal_skew_symmetric_diffusivity.jl`` +
    ``isopycnal_rotation_tensor_components.jl``).

    Tracer flux (small slope):
        Fx = −κ_R ∂x c − (κ_R − κ_GM) Sx ∂z c
        Fy = −κ_R ∂y c − (κ_R − κ_GM) Sy ∂z c
        Fz = −(κ_R + κ_GM)(Sx ∂x c + Sy ∂y c) − κ_R |S|² ∂z c − κ_z ∂z c
    with slopes Sx = −∂x b / ∂z b, Sy = −∂y b / ∂z b clipped at
    ``maximum_slope``.
    """

    def __init__(self, kappa_redi=1000.0, kappa_gm=1000.0,
                 maximum_slope=1e-2, kappa_z=1e-5):
        self.kappa_redi = float(kappa_redi)
        self.kappa_gm = float(kappa_gm)
        self.maximum_slope = float(maximum_slope)
        self.kappa_z = float(kappa_z)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        b = buoyancy.buoyancy_ccc(grid, tracers)
        return {"b": b}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        return 0.0, 0.0, 0.0

    def _taper(self, Sx, Sy):
        """Gerdes-Köberle-Willebrand slope taper min(1, (Smax/|S|)²)."""
        smax = self.maximum_slope
        S2 = Sx * Sx + Sy * Sy
        return jnp.minimum(1.0, smax * smax / jnp.maximum(S2, 1e-30))

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        """Fluxes assembled AT each face with identical stencils for the
        slope (from b) and the tracer gradients, so a tracer aligned with
        isopycnals (c ≡ b) feels exactly-zero Redi flux by algebraic
        cancellation — the discrete analog of the rotation-tensor property
        (reference isopycnal_rotation_tensor_components.jl)."""
        kR, kG = self.kappa_redi, self.kappa_gm
        b = diffusivities["b"]
        floor = 1e-12

        def grads_at_xface(q):
            qx = dx_f(q) / grid.dx(Face, Center)
            qz = ix_f(iz_c(dz_f(q) / grid.dz(Face)))
            return qx, qz

        def grads_at_yface(q):
            qy = dy_f(q) / grid.dy(Face, Center)
            qz = iy_f(iz_c(dz_f(q) / grid.dz(Face)))
            return qy, qz

        def grads_at_zface(q):
            qz = dz_f(q) / grid.dz(Face)
            qx = iz_f(ix_c(dx_f(q) / grid.dx(Face, Center)))
            qy = iz_f(iy_c(dy_f(q) / grid.dy(Face, Center)))
            return qx, qy, qz

        # The GKW taper multiplies the COMPLETE slope-dependent term (raw
        # slopes inside): tapered regions degrade gracefully to horizontal
        # diffusion while the Redi c≡b cancellation inside the taper factor
        # stays exact.

        # x-face flux
        bx, bzx = grads_at_xface(b)
        Sx_f = -bx / jnp.maximum(bzx, floor)
        tx = self._taper(Sx_f, 0.0)
        cx, czx = grads_at_xface(c)
        fx = kR * cx + tx * (kR - kG) * Sx_f * czx

        # y-face flux
        by, bzy = grads_at_yface(b)
        Sy_f = -by / jnp.maximum(bzy, floor)
        ty = self._taper(0.0, Sy_f)
        cy, czy = grads_at_yface(c)
        fy = kR * cy + ty * (kR - kG) * Sy_f * czy

        # z-face flux: slopes from the same z-face stencils; at wall faces
        # dz_f(b) -> 0 via mirror halos, slopes blow up, and the taper
        # drives the slope terms to zero automatically
        bxz, byz, bz = grads_at_zface(b)
        Sxz = -bxz / jnp.maximum(bz, floor)
        Syz = -byz / jnp.maximum(bz, floor)
        tz = self._taper(Sxz, Syz)
        cxz, cyz, cz = grads_at_zface(c)
        fz = (tz * ((kR + kG) * (Sxz * cxz + Syz * cyz)
                    + kR * (Sxz * Sxz + Syz * Syz) * cz)
              + self.kappa_z * cz)
        return _div_c_fluxes(grid, fx, fy, fz)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return (f"IsopycnalSkewSymmetricDiffusivity(κ_R={self.kappa_redi}, "
                f"κ_GM={self.kappa_gm})")
