"""Shallow-water + tracer dynamics on the six-panel conformal cubed
sphere.

Reference: ``src/MultiRegion/multi_region_models.jl`` +
``validation/multi_region/cubed_sphere_dynamics.jl`` (SURVEY.md §2.17).
The reference steps a MultiRegion of six panel grids with per-region
kernel launches and rotated halo fills; this design stacks the
panels on a leading axis — fields are (6, nx, ny, nz) arrays, the
per-panel vector-invariant tendency ``vmap``s over the panel axis, and
the inter-panel exchange is the numeric gather map of
``cubed_sphere_grid.py`` — so the whole RK3 step is ONE jitted XLA
program with no host round trips between panels.

The momentum equations use the vector-invariant (circulation) form,
which is metric-term-free on curvilinear grids: the Christoffel terms of
the panel coordinates never appear because vorticity is computed as a
circulation and kinetic energy as a scalar gradient (reference
``vector_invariant_advection.jl`` motivation).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu.advection import Centered, div_Uc
from oceananigans_tpu.buoyancy import g_Earth
from oceananigans_tpu.grids.base import Center, Face
from oceananigans_tpu.grids.cubed_sphere_grid import (
    ConformalCubedSphereGrid, _panel_xyz, cubed_sphere_corner_vorticity,
    cubed_sphere_halo_exchange, cubed_sphere_sync_edge_fluxes,
    cubed_sphere_velocity_exchange,
)
from oceananigans_tpu.ops.operators import (
    dx_c, dx_f, dy_c, dy_f, ix_c, ix_f, iy_c, iy_f, vorticity_z_ff,
)
from oceananigans_tpu.timesteppers import Clock, RK3_STAGES, tick

__all__ = ["CubedSphereShallowWaterModel", "CubedSphereState",
           "panel_vector_components"]

OMEGA_EARTH = 7.292115e-5


# ---------------------------------------------------------------------------
# Barotropic (free-surface) machinery shared by the serial stacked-panel
# model and the explicit-halo distributed step (which injects its own
# exchange/sync/dot closures). All fields are stacked (P, nx, ny, ·)
# arrays; ``g`` is the (possibly shard-local) panel grid.
# ---------------------------------------------------------------------------

def cs_column_depth(g):
    """Total fluid column depth Σ dz over interior z-cells, broadcastable
    against (P, nx, ny, 1) barotropic fields (flat-bottom cubed-sphere
    ocean: the reference's ``static_column_depthᶜᶜᵃ`` on a plain grid,
    ``grid_utils.jl:323-326``)."""
    dz = jnp.broadcast_to(g.dz(Center), g.shape)
    k = jnp.arange(g.shape[2]).reshape(1, 1, -1)
    interior = (k >= g.Hz) & (k < g.Hz + g.Nz)
    return jnp.sum(jnp.where(interior, dz, 0.0), axis=2,
                   keepdims=True)[None]


def cs_barotropic_mode(g, u, v, sigma_u=None, sigma_v=None):
    """(U, V) = ∫ u dz per panel of stacked (P, nx, ny, nz) velocities
    (reference ``_compute_barotropic_mode!``). Under ZStar pass the
    face σ so the transports integrate the moving thickness σ dz."""
    dz = jnp.broadcast_to(g.dz(Center), g.shape)[None]
    k = jnp.arange(g.shape[2]).reshape(1, 1, 1, -1)
    dzm = jnp.where((k >= g.Hz) & (k < g.Hz + g.Nz), dz, 0.0)
    dzu = dzm if sigma_u is None else sigma_u * dzm
    dzv = dzm if sigma_v is None else sigma_v * dzm
    U = jnp.sum(u * dzu, axis=3, keepdims=True)
    V = jnp.sum(v * dzv, axis=3, keepdims=True)
    return U, V


def cs_transport_divergence(g, U, V, sync_fluxes):
    """∇·(U, V) per unit area with edge-SYNCED panel fluxes: the flux
    leaving a panel through a shared edge face is exactly the flux
    entering its neighbor, so ∑ Az η is conserved to roundoff (the
    reference's shared multi-region face fluxes)."""
    Fx = g.dy(Center, Face)[:, :, :1][None] * U
    Fy = g.dx(Center, Face)[:, :, :1][None] * V
    Fx, Fy = sync_fluxes(Fx, Fy)
    Az = g.Az(Center, Center)[:, :, :1]
    return jax.vmap(lambda fx, fy: (dx_c(fx) + dy_c(fy)) / Az)(Fx, Fy)


def cs_eta_gradients(g, eta):
    """(∂x η at u-faces, ∂y η at v-faces) per panel; eta halos must be
    exchanged by the caller."""
    dxFC = g.dx(Face, Center)[:, :, :1]
    dyCF = g.dy(Center, Face)[:, :, :1]
    gx = jax.vmap(lambda e: dx_f(e) / dxFC)(eta)
    gy = jax.vmap(lambda e: dy_f(e) / dyCF)(eta)
    return gx, gy


def cs_split_explicit_free_surface(g, U0, V0, eta0, GU, GV, dt,
                                   fs, exchange_eta, sync_fluxes,
                                   mask_u, mask_v, Hu=None, Hv=None):
    """Barotropic substepping on the cubed sphere: ONE ``lax.scan`` over
    the averaging weights, each substep = forward η step (edge-synced
    transport divergence) + η panel exchange + backward transport step
    (reference ``multi_region_split_explicit_free_surface.jl:12-80`` +
    ``step_split_explicit_free_surface.jl:11-64``, re-expressed as a scan
    over stacked panels). ``U0``/``V0`` are the PERSISTENT barotropic
    transports (prognostic free-surface state, initialized once from the
    initial velocities and carried across steps — reference
    ``initialize_split_explicit_substepping.jl:15-25``: re-deriving them
    from the already-tendency-stepped baroclinic mode each step would
    double-count the slow forcing ``GU``). Returns filtered (η̄, Ū, V̄).

    ``Hu``/``Hv``: wet-column depths at the u/v faces (immersed
    bathymetry; reference ``static_column_depthᶠᶜᵃ``); default is the
    full flat-bottom column."""
    if Hu is None:
        Hu = Hv = cs_column_depth(g)
    dtau = fs.fractional_step * dt
    weights = np.asarray(fs.weights, np.float64)
    mu = jnp.asarray(mask_u, eta0.dtype)
    mv = jnp.asarray(mask_v, eta0.dtype)

    def substep(carry, wgt):
        eta, U, V, eta_f, U_f, V_f = carry
        eta = eta - dtau * cs_transport_divergence(g, U, V, sync_fluxes)
        eta = exchange_eta(eta)
        gx, gy = cs_eta_gradients(g, eta)
        U = (U + dtau * (-fs.g * Hu * gx + GU)) * mu
        V = (V + dtau * (-fs.g * Hv * gy + GV)) * mv
        return (eta, U, V, eta_f + wgt * eta, U_f + wgt * U,
                V_f + wgt * V), None

    init = (eta0, U0, V0, jnp.zeros_like(eta0), jnp.zeros_like(U0),
            jnp.zeros_like(V0))
    (eta, U, V, eta_f, U_f, V_f), _ = jax.lax.scan(
        substep, init, weights.astype(eta0.dtype))
    return eta_f, U_f, V_f


def cs_barotropic_correct(g, u, v, U_target, V_target, mask_u, mask_v,
                          Hu=None, Hv=None, sigma_u=None, sigma_v=None,
                          depth_u=None, depth_v=None):
    """Replace the barotropic mode of (u, v) with the filtered substepped
    transports (reference ``barotropic_split_explicit_corrector.jl``).
    ``Hu``/``Hv``: wet face-column depths (immersed bathymetry); land
    faces (depth 0) are left untouched. Under ZStar the baroclinic
    transport and the dividing thickness are both σ-scaled (reference
    column_depth = H + η on mutable grids). With partial bottom cells
    ``sigma_u`` carries the full 3-D per-cell thickness factor for the
    mode integral while ``depth_u`` carries the 2-D σ for the column
    depth (``Hu`` is already fraction-aware)."""
    U, V = cs_barotropic_mode(g, u, v, sigma_u, sigma_v)
    if Hu is None:
        Hu = Hv = cs_column_depth(g)
    if depth_u is not None:
        Hu = Hu * depth_u
        Hv = Hv * depth_v
    elif sigma_u is not None:
        Hu = Hu * sigma_u
        Hv = Hv * sigma_v
    Hu_safe = jnp.where(Hu > 0, Hu, 1.0)
    Hv_safe = jnp.where(Hv > 0, Hv, 1.0)
    u = u + jnp.where(Hu > 0, (U_target - U) / Hu_safe, 0.0) \
        * jnp.asarray(mask_u, u.dtype)
    v = v + jnp.where(Hv > 0, (V_target - V) / Hv_safe, 0.0) \
        * jnp.asarray(mask_v, v.dtype)
    return u, v


def cs_implicit_free_surface(g, u_star, v_star, eta0, dt, fs,
                             exchange_eta, sync_fluxes, mask_c,
                             dot=None, Hu=None, Hv=None):
    """Backward-Euler barotropic step across all panels: matrix-free CG
    on [∇·(gH∇) − 1/Δt²] η = (∇·U* − ηⁿ/Δt)/Δt with the panel exchange
    inside the operator (reference
    ``unified_implicit_free_surface_solver.jl:1-40`` — there a unified
    single-device solve across regions; here one CG whose operator spans
    the stacked panels). The inner product is Az-weighted, under which
    the flux-form operator is symmetric on the curvilinear panels."""
    from oceananigans_tpu.solvers.conjugate_gradient import (
        conjugate_gradient,
    )
    mc = jnp.asarray(mask_c, eta0.dtype)
    Az = g.Az(Center, Center)[:, :, :1][None] * mc
    if Hu is None:
        Hu = Hv = cs_column_depth(g)

    U, V = cs_barotropic_mode(g, u_star, v_star)
    div_U = cs_transport_divergence(g, U, V, sync_fluxes)
    rhs = (div_U - eta0 / dt) / dt * mc

    def L(eta):
        eta = exchange_eta(eta)
        gx, gy = cs_eta_gradients(g, eta)
        div = cs_transport_divergence(g, fs.g * Hu * gx, fs.g * Hv * gy,
                                      sync_fluxes)
        return (div - eta / (dt * dt)) * mc

    if dot is None:
        def dot(x, y):
            return jnp.sum(Az * x * y)

    eta, _, _ = conjugate_gradient(L, rhs, jnp.zeros_like(eta0),
                                   maxiter=fs.maxiter, reltol=fs.reltol,
                                   dot=dot)
    return exchange_eta(eta * mc)


class _PanelSolidView:
    """Panel-grid view exposing ``solid_c`` so the generic closure
    fluxes (``closures.py`` → ``immersed.mask_flux``) zero diffusive
    transport through the immersed boundary on the cubed sphere —
    horizontal stresses and tracer diffusion no longer leak at coastal
    walls (reference ``conditional_differences.jl``)."""

    def __init__(self, base, solid_c):
        object.__setattr__(self, "base", base)
        object.__setattr__(self, "solid_c", solid_c)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "base"), name)


def _vertex_orientation_masks(g, N):
    """(nx, ny, 4) one-hot masks of the 4 cube-corner VERTEX slots of a
    panel, by orientation (SW, SE, NW, NE). Shared across panels; the
    distributed wrappers block-window them like the corner mask."""
    H = g.Hx
    m = np.zeros((g.shape[0], g.shape[1], 4))
    m[H, H, 0] = 1.0
    m[H + N, H, 1] = 1.0
    m[H, H + N, 2] = 1.0
    m[H + N, H + N, 3] = 1.0
    return m


def _corner_vertex_scalar_fix(q_ff, h, vmasks):
    """Replace the 4 cube-corner VERTEX values of a vertex-located
    interpolant (built as ``ix_f(iy_f(h))``) with the mean of the 3 REAL
    adjacent cell values. The 4-point average reads the phantom diagonal
    halo cell — at a 3-valent cube corner no fourth cell exists, and the
    diagonal slot holds an ambiguous average of two different cells
    (whatever the halo exchange wrote). Mask-driven whole-array form
    (each orientation drops its phantom member), so it works unchanged
    on the distributed block layout."""
    A = h
    B = jnp.roll(h, 1, 0)
    C = jnp.roll(h, 1, 1)
    D = jnp.roll(B, 1, 1)
    third = jnp.asarray(1.0 / 3.0, h.dtype)
    means = (A + B + C, A + B + D, A + C + D, B + C + D)
    for k in range(4):
        m = vmasks[:, :, k:k + 1]
        q_ff = q_ff + m * (means[k] * third - q_ff)
    return q_ff


def _corner_bernoulli_upwind_correction(g, u, v, K, cmf):
    """Corner-band SELF-UPWINDED Bernoulli head: the correction that
    replaces the centered KE gradient ∂K with the own-component-biased
    form inside the corner band (reference ``bernoulli_head_U``,
    ``vector_invariant_self_upwinding.jl:60-81``, at first order).

    ROOT CAUSE of the cube-corner instability (round-5): at the
    3-valent corners the centered ∂x(K) closes a positive u² feedback
    loop — the growing corner velocity raises K, whose centered
    gradient accelerates the SAME face — which neither PV upwinding
    (it damps enstrophy, not energy) nor band-width/dt changes remove;
    measured e-folding ≈ 0.2 days at C32 Williamson-2, NaN by day 4.
    Upwinding the u²-part of ∂K (δx(u²/2) biased to the upwind cell by
    sign(u), the v²-part symmetric — exactly the reference's
    self-upwinding decomposition) makes the feedback dissipative:
    5-day inviscid C32 W2 stays bounded with NO filter. The centered
    and upwinded forms agree to O(Δx), so the scheme remains 2nd order
    outside the band and consistent inside it."""
    u2h = 0.5 * u * u
    v2h = 0.5 * v * v
    t1 = dx_c(u2h)
    t1f = jnp.where(u >= 0, jnp.roll(t1, 1, 0), t1)
    t2f = iy_c(dx_f(v2h))
    dKx_up = (t1f + t2f) / g.dx(Face, Center)
    dKx_c = dx_f(K) / g.dx(Face, Center)
    t1v = dy_c(v2h)
    t1vf = jnp.where(v >= 0, jnp.roll(t1v, 1, 1), t1v)
    t2vf = ix_c(dy_f(u2h))
    dKy_up = (t1vf + t2vf) / g.dy(Face, Center)
    dKy_c = dy_f(K) / g.dy(Face, Center)
    return cmf * (dKx_c - dKx_up), cmf * (dKy_c - dKy_up)


def _corner_filter_setup(model, corner_filter):
    """Precompute the corner-band filter weights. ``corner_filter`` is
    a small dimensionless coefficient (0.005 is a good default when
    enabled); the filter is a LOCAL Laplacian smoother confined to the
    ``corner_upwind_width`` band at the 24 panel corners — plain for
    velocities, conservative flux-form for cell-centered fields (the
    face-masked fluxes telescope, so ∑ q is preserved exactly, and the
    shared panel-edge fluxes agree across the exchange)."""
    model.corner_filter = (None if not corner_filter
                           else float(corner_filter))
    if model.corner_filter is None:
        return
    g = model.grid.panel_grid
    N, H = model.grid.N_panel, g.Hx
    cm = model._corner_mask[..., 0]                  # (nx, ny)
    fx = np.maximum(cm, np.roll(cm, 1, axis=0))     # x-face coverage
    fy = np.maximum(cm, np.roll(cm, 1, axis=1))     # y-face coverage
    # WITHIN-panel faces only: the filter never fluxes across the
    # shared panel-edge faces, so the Az-weighted content telescopes
    # exactly per panel (no cross-edge cancellation to rely on)
    idx = np.arange(fx.shape[0])
    inner_x = ((idx > H) & (idx < H + N)).astype(float)
    inner_y = inner_x
    fx = fx * inner_x[:, None]
    fy = fy * inner_y[None, :]
    eps = model.corner_filter
    Az = np.asarray(g.Az(Center, Center))[:, :, 0]
    Az_fx = 0.5 * (Az + np.roll(Az, 1, axis=0))
    Az_fy = 0.5 * (Az + np.roll(Az, 1, axis=1))
    model._cf_x = (eps * fx * Az_fx)[..., None]
    model._cf_y = (eps * fy * Az_fy)[..., None]
    model._cf_inv_az = (1.0 / Az)[..., None]
    # keep the filter from reaching across the immersed bottom. The wet
    # masks must be restricted to INTERIOR z-levels here: the z-HALO
    # slots sit above the surface, where zc > terrain height marks
    # halo cells "wet" even over land — the 2-D (η) smoothing's
    # max-over-z weight reduction would then flux volume into land
    # columns (round-5 leak: 2e-11/step in the C48 global ocean).
    wu = getattr(model, "_wet_u", None)
    if wu is not None:
        gz = model.grid.panel_grid
        kz = np.arange(gz.shape[2]).reshape(1, 1, 1, -1)
        kin_z = ((kz >= gz.Hz) & (kz < gz.Hz + gz.Nz)).astype(float)
        model._cf_x = model._cf_x[None] * np.asarray(model._wet_u) * kin_z
        model._cf_y = model._cf_y[None] * np.asarray(model._wet_v) * kin_z


def _corner_smooth_center(model, q):
    """Az-content-conserving corner-band smoothing of a stacked cell
    field: Δq = ∇·(w ∇q)/Az with face weights confined to the corner
    band and to within-panel faces — ∑ Az q is exact by telescoping."""
    cfx = jnp.asarray(model._cf_x, q.dtype)
    cfy = jnp.asarray(model._cf_y, q.dtype)
    inv_az = jnp.asarray(model._cf_inv_az, q.dtype)
    if cfx.ndim == 3:
        def panel(a):
            return a + (dx_c(cfx * dx_f(a))
                        + dy_c(cfy * dy_f(a))) * inv_az
        return jax.vmap(panel)(q)
    # bathymetry: stacked (wet-masked) face weights; reduced fields
    # (eta's single level) take the any-wet column weight
    if q.shape[-1] != cfx.shape[-1]:
        cfx = jnp.max(cfx, axis=-1, keepdims=True)
        cfy = jnp.max(cfy, axis=-1, keepdims=True)

    def panel(a, wx, wy):
        return a + (dx_c(wx * dx_f(a)) + dy_c(wy * dy_f(a))) * inv_az
    return jax.vmap(panel)(q, cfx, cfy)


def _corner_smooth_velocity(model, q, mask):
    """Plain corner-band Laplacian smoothing of a velocity component
    (no conservation requirement); ``mask`` confines the update to the
    component's interior/wet faces."""
    eps = model.corner_filter
    cm = jnp.asarray(model._corner_mask, q.dtype)

    def panel(a):
        lap = (jnp.roll(a, 1, 0) + jnp.roll(a, -1, 0)
               + jnp.roll(a, 1, 1) + jnp.roll(a, -1, 1) - 4.0 * a)
        return a + eps * cm * lap

    return q + (jax.vmap(panel)(q) - q) * jnp.asarray(mask, q.dtype)


def _tangents(p, x, y, axis, h=1e-6):
    """(n, 3) unit tangents of panel p's grid direction at panel coords."""
    x = np.asarray(x, float).ravel()
    y = np.asarray(y, float).ravel()
    if axis == 0:
        d = _panel_xyz(p, x + h, y) - _panel_xyz(p, x - h, y)
    else:
        d = _panel_xyz(p, x, y + h) - _panel_xyz(p, x, y - h)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def panel_vector_components(grid: ConformalCubedSphereGrid, vec_fn):
    """Project a cartesian vector field onto every panel's staggered
    (u, v) components.

    ``vec_fn(P)`` maps (n, 3) unit-sphere cartesian points to (n, 3)
    velocity vectors. Returns stacked co-shaped (6, nx, ny, 1) ``u``
    (x-face) and ``v`` (y-face) arrays with interior (+ shared edge
    face) slots filled."""
    g = grid.panel_grid
    N, H = grid.N_panel, g.Hx
    nx, ny, _ = g.shape
    d = 2.0 / N
    u = np.zeros((6, nx, ny, 1))
    v = np.zeros((6, nx, ny, 1))

    for comp in ("u", "v"):
        if comp == "u":
            ii = np.arange(H, H + N + 1)
            jj = np.arange(H, H + N)
            xs = -1.0 + (ii - H) * d
            ys = -1.0 + (jj - H + 0.5) * d
        else:
            ii = np.arange(H, H + N)
            jj = np.arange(H, H + N + 1)
            xs = -1.0 + (ii - H + 0.5) * d
            ys = -1.0 + (jj - H) * d
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        ax = 0 if comp == "u" else 1
        for p in range(6):
            P = _panel_xyz(p, X.ravel(), Y.ravel())
            T = _tangents(p, X.ravel(), Y.ravel(), ax)
            vals = (vec_fn(P) * T).sum(-1).reshape(X.shape)
            tgt = u if comp == "u" else v
            tgt[p, ii[0]:ii[-1] + 1, jj[0]:jj[-1] + 1, 0] = vals
    return jnp.asarray(u), jnp.asarray(v)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CubedSphereState:
    """Stacked-panel prognostic state: (6, nx, ny, nz) arrays."""
    u: jnp.ndarray
    v: jnp.ndarray
    h: jnp.ndarray
    tracers: Dict[str, jnp.ndarray]
    Gu: jnp.ndarray
    Gv: jnp.ndarray
    Gh: jnp.ndarray
    Gtracers: Dict[str, jnp.ndarray]
    clock: Clock

    def fields(self):
        return {"u": self.u, "v": self.v, "h": self.h, **self.tracers}


class CubedSphereShallowWaterModel:
    """Vector-invariant shallow water on the conformal cubed sphere.

    ``prescribed_velocities=True`` freezes (u, v, h) and steps only the
    tracers — the reference's ``PrescribedVelocityFields`` mode used for
    the Williamson advection test cases."""

    def __init__(self, grid: ConformalCubedSphereGrid,
                 gravitational_acceleration=g_Earth,
                 rotation_rate=OMEGA_EARTH,
                 tracer_advection=None,
                 tracers=(),
                 prescribed_velocities=False,
                 vorticity_scheme="hybrid_upwind",
                 corner_upwind_width=4,
                 corner_filter=None,
                 bathymetry=None):
        self.grid = grid
        self.g = float(gravitational_acceleration)
        # surface topography height hs(λ, φ) (reference shallow-water
        # bathymetry; Williamson 5's isolated mountain): the momentum
        # gradient acts on g·(h + hs) while mass conservation advects
        # the fluid depth h alone
        if bathymetry is None:
            self.hs = None
        else:
            hs = bathymetry if hasattr(bathymetry, "ndim") \
                else grid.set_tracer(
                    lambda lam, phi, z: bathymetry(lam, phi) + 0 * z)
            hs = cubed_sphere_halo_exchange(jnp.asarray(hs), grid)
            # single z level, like the state fields (a z-extended hs
            # would broadcast every tendency to the z-halo slots)
            g = grid.panel_grid
            if hs.shape[-1] != 1:
                hs = hs[..., g.Hz:g.Hz + 1]
            self.hs = hs
        self.rotation_rate = float(rotation_rate or 0.0)
        self.tracer_advection = tracer_advection or Centered(2)
        self.tracer_names = tuple(tracers)
        self.prescribed_velocities = bool(prescribed_velocities)
        #: potential-vorticity flux scheme. The conformal-corner
        #: truncation is scale-invariant O(1), so the q-flux needs
        #: implicit dissipation there; away from corners higher order
        #: pays off directly in the Williamson-2 error:
        #: - "hybrid_upwind" (default): first-order upwind within
        #:   ``corner_upwind_width`` cells of each cube corner,
        #:   3rd-order UpwindBiased elsewhere (C32 W2 5-day L2 0.24%
        #:   vs 2.0% for pure first-order; pure 3rd order blows up).
        #: - "upwind": first-order everywhere (most robust).
        #: - "energy_conserving": Sadourny centered form (inviscid;
        #:   unstable at the corners — for planar/testing use).
        self.vorticity_scheme = vorticity_scheme
        self.corner_upwind_width = int(corner_upwind_width)

        g = grid.panel_grid
        N, H = grid.N_panel, g.Hx
        nx, ny, _ = g.shape
        d = 2.0 / N

        # Coriolis parameter at each panel's (f, f) points, halos
        # included (the analytic extension is fine: only interior
        # vorticity points are consumed)
        iF = -1.0 + (np.arange(nx) - H) * d
        jF = -1.0 + (np.arange(ny) - H) * d
        X, Y = np.meshgrid(iF, jF, indexing="ij")
        f = []
        for p in range(6):
            P = _panel_xyz(p, X.ravel(), Y.ravel()).reshape(nx, ny, 3)
            sin_phi = np.clip(P[..., 2], -1.0, 1.0)
            f.append(2.0 * self.rotation_rate * sin_phi)
        self.f_ff = np.stack(f)[..., None]          # (6, nx, ny, 1)

        # interior masks (keep halo garbage from accumulating between
        # the per-stage exchanges); face masks include the shared edge
        mc = np.zeros((nx, ny, 1))
        mc[H:H + N, H:H + N] = 1.0
        mu = np.zeros((nx, ny, 1))
        mu[H:H + N + 1, H:H + N] = 1.0
        mv = np.zeros((nx, ny, 1))
        mv[H:H + N, H:H + N + 1] = 1.0
        self._mask_c, self._mask_u, self._mask_v = mc, mu, mv
        idx = np.arange(nx)
        near = (idx < H + self.corner_upwind_width) \
            | (idx >= H + N - self.corner_upwind_width)
        self._corner_mask = (near[:, None]
                             & near[None, :]).astype(float)[..., None]
        wke = min(int(os.environ.get("CS_KE_BAND", "2")),
                  self.corner_upwind_width)
        near_ke = (idx < H + wke) | (idx >= H + N - wke)
        self._corner_mask_ke = (near_ke[:, None]
                                & near_ke[None, :]).astype(
                                    float)[..., None]
        self._vfix = _vertex_orientation_masks(g, N)
        #: optional corner-band filter coefficient (see
        #: _corner_filter_setup). Since round 5 the former corner
        #: instability is ROOT-CAUSE fixed (the corner-band
        #: self-upwinded Bernoulli head,
        #: ``_corner_bernoulli_upwind_correction``) — 5-day inviscid
        #: C32 Williamson-2 is stable and in the published band with NO
        #: filter (l2(h) = 3.1e-3). The filter remains available as
        #: extra smoothing for very long / coarse runs (real
        #: cubed-sphere cores carry equivalent options, e.g. FV3).
        _corner_filter_setup(self, corner_filter)

    # ------------------------------------------------------------------
    def initial_state(self, u=None, v=None, h=1.0, time=0.0, **tracers):
        """``u``/``v``: stacked arrays (from ``panel_vector_components``)
        or None; ``h``: scalar or stacked array; tracers by name
        (stacked arrays or callables ``f(lam, phi, z)`` in degrees)."""
        grid = self.grid
        g = grid.panel_grid
        nx, ny, _ = g.shape

        def one_level(a):
            """The SW layer is 2-D: collapse any z-extended field to its
            single interior level so no z-halo slot (h = 0 there) can
            feed a 1/h."""
            a = jnp.asarray(a)
            if a.shape[-1] != 1:
                a = a[..., g.Hz:g.Hz + 1]
            return a

        zero = jnp.zeros((6, nx, ny, 1), grid.new_field().dtype)
        u = zero if u is None else one_level(u).astype(zero.dtype)
        v = zero if v is None else one_level(v).astype(zero.dtype)
        if jnp.ndim(h) == 0:
            h = jnp.full_like(zero, h) * jnp.asarray(self._mask_c,
                                                     zero.dtype)
        else:
            h = one_level(h)
        tr = {}
        for name in self.tracer_names:
            val = tracers.get(name, 0.0)
            if callable(val):
                tr[name] = one_level(grid.set_tracer(val))
            elif jnp.ndim(val) == 0:
                tr[name] = jnp.full_like(zero, val) * jnp.asarray(
                    self._mask_c, zero.dtype)
            else:
                tr[name] = one_level(val).astype(zero.dtype)
        state = CubedSphereState(
            u=u, v=v, h=jnp.asarray(h, zero.dtype), tracers=tr,
            Gu=zero, Gv=zero, Gh=zero,
            Gtracers={n: zero for n in self.tracer_names},
            clock=Clock.start(time=float(time), dtype=zero.dtype))
        return self.fill_state_halos(state)

    # ------------------------------------------------------------------
    def fill_state_halos(self, state):
        grid = self.grid
        u, v = cubed_sphere_velocity_exchange(state.u, state.v, grid)
        h = cubed_sphere_halo_exchange(state.h, grid)
        tracers = {n: cubed_sphere_halo_exchange(c, grid)
                   for n, c in state.tracers.items()}
        return dataclasses.replace(state, u=u, v=v, h=h, tracers=tracers)

    # ------------------------------------------------------------------
    def _panel_tendencies(self, u, v, h, f_ff, zeta, tracers, hs=None):
        """Per-panel tendencies (vmapped over the panel axis);
        ``zeta`` is precomputed on the stacked array (the cube-corner
        circulation fix couples panels)."""
        g = self.grid.panel_grid
        U = u * ix_f(h)
        V = v * iy_f(h)
        # Sadourny (1975) energy-conserving form: POTENTIAL vorticity
        # q = (zeta + f)/h at vorticity points, momentum tendency
        # q-flux of the layer transports. The conservation property is
        # what keeps the inviscid sphere stable; dividing by h outside
        # the averages (a consistent but non-conservative variant) blows
        # up at the panel seams.
        eps = jnp.asarray(1e-30, h.dtype)
        h_ff = ix_f(iy_f(h))
        h_ff = _corner_vertex_scalar_fix(
            h_ff, h, jnp.asarray(self._vfix, h.dtype))
        q = (zeta + f_ff) / (h_ff + eps)
        K = 0.5 * (ix_c(u * u) + iy_c(v * v))
        phi = K + self.g * (h if hs is None else h + hs)
        if self.vorticity_scheme in ("upwind", "hybrid_upwind"):
            # length-weighted transverse transports (same metric
            # weighting as the reference's vector-invariant forms)
            Vu = ix_f(iy_c(g.dx(Center, Face) * V)) / g.dx(Face, Center)
            Uv = iy_f(ix_c(g.dy(Center, Face) * U)) / g.dy(Face, Center)
            q1y = jnp.where(Vu >= 0, q, jnp.roll(q, -1, 1))
            q1x = jnp.where(Uv >= 0, q, jnp.roll(q, -1, 0))
            if self.vorticity_scheme == "hybrid_upwind":
                from oceananigans_tpu.advection import (
                    UpwindBiased, _face_value,
                )
                cm = jnp.asarray(self._corner_mask, q.dtype)
                ub3 = UpwindBiased(3)
                q_up = cm * q1y + (1 - cm) * _face_value(ub3, Vu, q, 1, 1)
                q_upx = cm * q1x \
                    + (1 - cm) * _face_value(ub3, Uv, q, 0, 1)
            else:
                q_up, q_upx = q1y, q1x
            Gu = q_up * Vu - dx_f(phi) / g.dx(Face, Center)
            Gv = -q_upx * Uv - dy_f(phi) / g.dy(Face, Center)
            cmf = jnp.asarray(self._corner_mask_ke, q.dtype)
            dGu, dGv = _corner_bernoulli_upwind_correction(g, u, v, K,
                                                           cmf)
            Gu = Gu + dGu
            Gv = Gv + dGv
        else:
            Gu = iy_c(q * ix_f(V)) - dx_f(phi) / g.dx(Face, Center)
            Gv = -ix_c(q * iy_f(U)) - dy_f(phi) / g.dy(Face, Center)
        return Gu, Gv

    def _panel_fluxes(self, u, v, h, tracers):
        """Per-panel mass + tracer advective fluxes (before the edge
        synchronization that makes shared-face fluxes single-valued)."""
        from oceananigans_tpu.advection import _face_value, _scheme_for
        g = self.grid.panel_grid
        U = u * ix_f(h)
        V = v * iy_f(h)
        Fx = g.dy(Center, Face) * U
        Fy = g.dx(Center, Face) * V
        # single-level model: slice the z-extended metrics to the
        # interior level so the fluxes don't broadcast the state to the
        # full z extent
        kz = slice(g.Hz, g.Hz + 1)
        Ft = {}
        for name, c in tracers.items():
            sxs = _scheme_for(self.tracer_advection, 0)
            sys_ = _scheme_for(self.tracer_advection, 1)
            fcx = g.Ax(Face, Center, Center)[:, :, kz] * u \
                * _face_value(sxs, u, c, 0, 0)
            fcy = g.Ay(Center, Face, Center)[:, :, kz] * v \
                * _face_value(sys_, v, c, 1, 0)
            Ft[name] = (fcx, fcy)
        return Fx, Fy, Ft

    def _panel_flux_divergence(self, Fx, Fy, Ft):
        g = self.grid.panel_grid
        kz = slice(g.Hz, g.Hz + 1)
        Gh = -(dx_c(Fx) + dy_c(Fy)) / g.Az(Center, Center)
        Gt = {name: -(dx_c(fcx) + dy_c(fcy))
              / g.V(Center, Center, Center)[:, :, kz]
              for name, (fcx, fcy) in Ft.items()}
        return Gh, Gt

    def compute_tendencies(self, state):
        mu = jnp.asarray(self._mask_u, state.u.dtype)
        mv = jnp.asarray(self._mask_v, state.u.dtype)
        mc = jnp.asarray(self._mask_c, state.u.dtype)
        f = jnp.asarray(self.f_ff, state.u.dtype)
        g = self.grid.panel_grid
        zeta = jax.vmap(lambda up, vp: vorticity_z_ff(g, up, vp))(
            state.u, state.v)
        # exact 3-segment circulation at the 8 cube-corner vertices (the
        # standard 4-segment form is O(1) wrong at 3-valent corners)
        zeta = cubed_sphere_corner_vorticity(zeta, state.u, state.v,
                                             self.grid)
        if self.hs is None:
            Gu, Gv = jax.vmap(self._panel_tendencies,
                              in_axes=(0, 0, 0, 0, 0, 0))(
                state.u, state.v, state.h, f, zeta, state.tracers)
        else:
            hs = jnp.asarray(self.hs, state.h.dtype)
            Gu, Gv = jax.vmap(self._panel_tendencies,
                              in_axes=(0, 0, 0, 0, 0, 0, 0))(
                state.u, state.v, state.h, f, zeta, state.tracers, hs)
        # conservation: compute mass/tracer fluxes per panel, then make
        # the fluxes through shared edge faces single-valued before the
        # divergence (flux out of one panel == flux into its neighbor
        # exactly)
        Fx, Fy, Ft = jax.vmap(self._panel_fluxes)(
            state.u, state.v, state.h, state.tracers)
        Fx, Fy = cubed_sphere_sync_edge_fluxes(Fx, Fy, self.grid)
        Ft = {name: cubed_sphere_sync_edge_fluxes(fcx, fcy, self.grid)
              for name, (fcx, fcy) in Ft.items()}
        Gh, Gt = jax.vmap(self._panel_flux_divergence)(
            Fx, Fy, {n: tuple(f) for n, f in Ft.items()})
        if self.prescribed_velocities:
            Gu = jnp.zeros_like(Gu)
            Gv = jnp.zeros_like(Gv)
            Gh = jnp.zeros_like(Gh)
        else:
            Gu = Gu * mu
            Gv = Gv * mv
            Gh = Gh * mc
        Gt = {n: G * mc for n, G in Gt.items()}
        return Gu, Gv, Gh, Gt

    # ------------------------------------------------------------------
    def step(self, state, dt):
        """RK3 with per-stage inter-panel halo exchange (the reference's
        multi-region fill between substeps)."""
        dt = jnp.asarray(dt, state.h.dtype)
        G_prev = (state.Gu, state.Gv, state.Gh, state.Gtracers)
        for gamma, zeta in RK3_STAGES:
            state = self.fill_state_halos(state)
            Gu, Gv, Gh, Gt = self.compute_tendencies(state)
            state = dataclasses.replace(
                state,
                u=state.u + dt * (gamma * Gu + zeta * G_prev[0]),
                v=state.v + dt * (gamma * Gv + zeta * G_prev[1]),
                h=state.h + dt * (gamma * Gh + zeta * G_prev[2]),
                tracers={
                    n: state.tracers[n]
                    + dt * (gamma * Gt[n] + zeta * G_prev[3][n])
                    for n in self.tracer_names})
            G_prev = (Gu, Gv, Gh, Gt)
        state = dataclasses.replace(
            state, Gu=G_prev[0], Gv=G_prev[1], Gh=G_prev[2],
            Gtracers=G_prev[3], clock=tick(state.clock, dt))
        if self.corner_filter is not None \
                and not self.prescribed_velocities:
            # filter on FILLED halos (the Laplacian taps reach one ring
            # into the exchanged region), then re-fill
            state = self.fill_state_halos(state)
            state = dataclasses.replace(
                state,
                u=_corner_smooth_velocity(self, state.u, self._mask_u),
                v=_corner_smooth_velocity(self, state.v, self._mask_v),
                h=_corner_smooth_center(self, state.h))
        return self.fill_state_halos(state)

    # ------------------------------------------------------------------
    def total_mass(self, state):
        g = self.grid.panel_grid
        sx, sy, _ = g.interior_slices
        Az = g.Az(Center, Center)[sx, sy, :]
        # the SW state is single-level (initial_state collapses z), so
        # the full z slice is exactly the one layer
        return jnp.sum(state.h[:, sx, sy, :] * Az)

    def total_tracer(self, state, name):
        g = self.grid.panel_grid
        sx, sy, _ = g.interior_slices
        Az = g.Az(Center, Center)[sx, sy, :]
        return jnp.sum(state.tracers[name][:, sx, sy, :]
                       * state.h[:, sx, sy, :] * Az)

    def __repr__(self):
        return (f"CubedSphereShallowWaterModel(N={self.grid.N_panel}, "
                f"tracers={list(self.tracer_names)}, "
                f"prescribed={self.prescribed_velocities})")


# ---------------------------------------------------------------------------
# 3-D hydrostatic primitive equations on the cubed sphere
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CubedSphereHydrostaticState:
    """Stacked-panel hydrostatic state: (6, nx, ny, nz) u, v, tracers;
    (6, nx, ny, 1) eta and persistent barotropic transports U, V (the
    split-explicit free surface's own prognostic state; barotropic mode
    of the velocities otherwise). ``Gu``/``Gv``/``Geta``/``Gtracers``
    carry the previous tendencies under the quasi-AB2 stepper (None for
    RK3) — checkpointed, so AB2 restarts are exact (reference
    ``checkpointer.jl:20-26``)."""
    u: jnp.ndarray
    v: jnp.ndarray
    eta: jnp.ndarray
    tracers: Dict[str, jnp.ndarray]
    clock: Clock
    U: jnp.ndarray = None
    V: jnp.ndarray = None
    Gu: jnp.ndarray = None
    Gv: jnp.ndarray = None
    Geta: jnp.ndarray = None
    Gtracers: Dict[str, jnp.ndarray] = None

    def fields(self):
        return {"u": self.u, "v": self.v, "eta": self.eta,
                **self.tracers}


class CubedSphereHydrostaticModel:
    """Hydrostatic Boussinesq primitive equations on the six-panel
    conformal cubed sphere (reference: the MultiRegion hydrostatic
    configuration of ``multi_region_models.jl`` +
    ``hydrostatic_free_surface_model.jl``, re-designed for the stacked
    panel axis).

    Vector-invariant momentum with the upwinded (ζ+f) flux and the
    exact cube-corner circulation; w diagnosed from continuity per
    column; hydrostatic pressure p′ = −∫ b dz; explicit free surface
    with edge-synced barotropic transports (global volume conservation
    to machine precision); SSP-RK3 stepping with per-stage inter-panel
    exchange. Buoyancy enters as the tracer ``b`` (BuoyancyTracer
    semantics)."""

    def __init__(self, grid: ConformalCubedSphereGrid,
                 gravitational_acceleration=g_Earth,
                 rotation_rate=OMEGA_EARTH,
                 momentum_advection=None,
                 tracer_advection=None,
                 tracers=("b",),
                 buoyancy="default",
                 closure=None,
                 forcing=None,
                 boundary_conditions=None,
                 bathymetry=None,
                 free_surface=None,
                 prescribed_velocities=False,
                 timestepper="RungeKutta3",
                 vertical_coordinate=None,
                 corner_upwind_width=4,
                 corner_filter=None):
        """``closure``: any closure (or tuple) from the main stack — it is
        applied per panel through the standard
        ``closures.compute_diffusivities`` / flux-divergence /
        ``implicit_vertical_diffusion_step`` machinery (vertically-implicit
        closures like CATKE get the same column Thomas solve the
        rectilinear hydrostatic model uses).

        ``momentum_advection``: ``None`` (default) keeps the hybrid
        UB1/UB3 upwinded (ζ+f) flux; a ``VectorInvariant`` /
        ``WENOVectorInvariant`` instance runs the full flat-model
        vector-invariant option matrix per panel (reference regionalizes
        the same types, ``multi_region_models.jl:70-79``), blended back
        to the robust hybrid form inside the corner band. Requires the
        grid halo to cover the scheme stencil.

        ``buoyancy``: ``"default"`` selects ``BuoyancyTracer()`` when a
        ``"b"`` tracer is present; any formulation from
        :mod:`oceananigans_tpu.buoyancy` works (``SeawaterBuoyancy`` with
        linear or TEOS-10 EOS adds its T/S tracers — reference
        ``seawater_buoyancy.jl:11`` is grid-agnostic).

        ``bathymetry``: a ``GridFittedBottom``, a callable
        ``h(lam_deg, phi_deg) -> bottom z`` (negative depths, ≥ 0 for
        land), or a stacked bottom-height array — immersed bottom
        topography (reference regionalized ``GridFittedBottom``,
        ``multi_region_models.jl:35-45`` + ``multi_region_grid.jl:190``).
        Solid cells are masked; vertical no-flux is enforced by
        mirroring the bottom-most wet value downward each exchange, and
        barotropic depths become wet-column depths.

        ``forcing``: dict ``name -> f(lam_deg, phi_deg, z, t)`` for
        tracers AND ``"u"``/``"v"`` momentum (evaluated at the staggered
        geographic points each RK stage — the reference's multi-region
        ``@apply_regionally`` forcing dispatch).

        ``boundary_conditions``: dict ``name ->
        FieldBoundaryConditions(top=FluxBC(...), bottom=FluxBC(...))``
        applying surface/bottom fluxes (wind stress, heat/salt flux,
        bottom drag) into the tendencies at the top / bottom-most wet
        cell (reference ``multi_region_boundary_conditions.jl:1-62`` +
        ``apply_flux_bcs.jl``). Flux values may be scalars, stacked
        arrays, or callables ``f(lam_deg, phi_deg, t, *field_deps)``
        with ``field_dependencies`` receiving boundary-adjacent fields.

        ``prescribed_velocities=True`` freezes (u, v, eta) and steps
        only the tracers (reference ``PrescribedVelocityFields`` in the
        regionalized-type list, ``multi_region_models.jl:35-45``).

        ``timestepper``: "RungeKutta3" (SSP-RK3, default) or
        "QuasiAdamsBashforth2" (χ-weighted AB2 with a branch-free Euler
        first step; the tendency history lives in the state and is
        checkpointed — reference ``quasi_adams_bashforth_2.jl:74-175``
        in the regionalized-type list).

        ``vertical_coordinate``: ``ZCoordinate()`` (fixed z, default) or
        ``ZStar()`` — free-surface-following vertical spacings, AB2
        stepper only (σ-weighted tendencies + post-update σⁿ/σⁿ⁺¹
        rescale conserve ∫σ q dV exactly; reference
        ``z_star_vertical_spacing.jl`` in the regionalized-type list)."""
        if timestepper in ("AB2", "ab2"):
            timestepper = "QuasiAdamsBashforth2"
        if timestepper not in ("RungeKutta3", "QuasiAdamsBashforth2"):
            raise ValueError(f"unknown timestepper {timestepper!r}")
        self.timestepper = timestepper
        from oceananigans_tpu.models.hydrostatic import ZCoordinate, ZStar
        if vertical_coordinate is None:
            vertical_coordinate = ZCoordinate()
        self.vertical_coordinate = vertical_coordinate
        self._zstar = isinstance(vertical_coordinate, ZStar)
        if self._zstar and timestepper != "QuasiAdamsBashforth2":
            raise ValueError("cubed-sphere ZStar needs "
                             "timestepper='QuasiAdamsBashforth2'")
        self.corner_upwind_width = int(corner_upwind_width)
        self.grid = grid
        self.g = float(gravitational_acceleration)
        self.rotation_rate = float(rotation_rate or 0.0)
        self.prescribed_velocities = bool(prescribed_velocities)
        # free surface: explicit (default — the round-2 behavior),
        # split-explicit barotropic substepping, or implicit (CG across
        # panels). Reference: multi_region_split_explicit_free_surface.jl
        # + unified_implicit_free_surface_solver.jl.
        from oceananigans_tpu.models.hydrostatic import (
            ExplicitFreeSurface, ImplicitFreeSurface,
            SplitExplicitFreeSurface,
        )
        if free_surface is None:
            free_surface = ExplicitFreeSurface(gravitational_acceleration)
        if isinstance(free_surface, ImplicitFreeSurface) \
                and free_surface.solver_method != "cg":
            raise ValueError(
                "the cubed sphere supports ImplicitFreeSurface("
                "solver_method='cg') only (spectral/matrix solvers need "
                "a separable grid)")
        if not isinstance(free_surface, (ExplicitFreeSurface,
                                         ImplicitFreeSurface,
                                         SplitExplicitFreeSurface)):
            raise ValueError(f"unknown free surface {free_surface!r}")
        self.free_surface = free_surface
        self.g = float(free_surface.g)
        #: the momentum tendency carries the −g∇η term only when the free
        #: surface is stepped explicitly (the split/implicit paths apply
        #: the barotropic gradient in their own sub/implicit steps)
        self._explicit_eta_grad = isinstance(free_surface,
                                             ExplicitFreeSurface)
        self.tracer_advection = tracer_advection or Centered(2)
        from oceananigans_tpu import closures as closures_mod
        from oceananigans_tpu.buoyancy import BuoyancyTracer
        tracers = tuple(tracers)
        if buoyancy == "default":
            buoyancy = BuoyancyTracer() if "b" in tracers else None
        self.buoyancy = buoyancy
        if buoyancy is not None:
            for t in buoyancy.required_tracers:
                if t not in tracers:
                    tracers = tracers + (t,)
        for cl in closures_mod._as_tuple(closure):
            for t in getattr(cl, "required_tracers", ()):
                if t not in tracers:
                    tracers = tracers + (t,)
        self.tracer_names = tuple(tracers)
        self.closure = closure
        self.momentum_advection = momentum_advection
        if momentum_advection is not None:
            from oceananigans_tpu.models.hydrostatic import VectorInvariant
            if not isinstance(momentum_advection, VectorInvariant):
                raise ValueError(
                    "cubed-sphere momentum_advection must be a "
                    "VectorInvariant/WENOVectorInvariant instance or None "
                    f"(the default hybrid upwinding), got "
                    f"{momentum_advection!r}")
            need = momentum_advection.required_halo
            if grid.panel_grid.Hx < need:
                raise ValueError(
                    f"{momentum_advection!r} needs a panel halo of "
                    f"{need} (grid has {grid.panel_grid.Hx}); rebuild "
                    f"the grid with halo={need}")
        self.forcings = dict(forcing or {})
        for name in self.forcings:
            if name not in self.tracer_names and name not in ("u", "v"):
                raise ValueError(
                    f"cubed-sphere forcing supports tracers and u/v "
                    f"momentum, got {name!r}")
        self.bcs = dict(boundary_conditions or {})
        for name, fbc in self.bcs.items():
            if name not in self.tracer_names and name not in ("u", "v"):
                raise ValueError(
                    f"cubed-sphere boundary_conditions support tracers "
                    f"and u/v momentum, got {name!r}")
            from oceananigans_tpu.boundary_conditions import FLUX
            for side in ("west", "east", "south", "north"):
                if getattr(fbc, side, None) is not None:
                    raise ValueError(
                        "the cubed sphere has no lateral open boundaries; "
                        "only top/bottom flux conditions apply")
            for side in ("top", "bottom"):
                bc = getattr(fbc, side, None)
                if bc is not None and bc.classification != FLUX:
                    raise ValueError(
                        f"cubed-sphere {side} conditions must be FluxBC "
                        f"(got {bc.classification} for {name!r})")
        # closures that need a buoyancy model see this model's buoyancy
        # formulation
        self._closure_buoyancy = buoyancy
        g = grid.panel_grid
        N, H = grid.N_panel, g.Hx
        nx, ny, _ = g.shape
        d = 2.0 / N
        iF = -1.0 + (np.arange(nx) - H) * d
        X, Y = np.meshgrid(iF, iF, indexing="ij")
        f = []
        for p in range(6):
            P = _panel_xyz(p, X.ravel(), Y.ravel()).reshape(nx, ny, 3)
            f.append(2.0 * self.rotation_rate
                     * np.clip(P[..., 2], -1.0, 1.0))
        self.f_ff = np.stack(f)[..., None]
        mc = np.zeros((nx, ny, 1))
        mc[H:H + N, H:H + N] = 1.0
        mu = np.zeros((nx, ny, 1))
        mu[H:H + N + 1, H:H + N] = 1.0
        mv = np.zeros((nx, ny, 1))
        mv[H:H + N, H:H + N + 1] = 1.0
        self._mask_c, self._mask_u, self._mask_v = mc, mu, mv
        idx = np.arange(nx)
        near = (idx < H + self.corner_upwind_width) \
            | (idx >= H + N - self.corner_upwind_width)
        self._corner_mask = (near[:, None]
                             & near[None, :]).astype(float)[..., None]
        wke = min(int(os.environ.get("CS_KE_BAND", "2")),
                  self.corner_upwind_width)
        near_ke = (idx < H + wke) | (idx >= H + N - wke)
        self._corner_mask_ke = (near_ke[:, None]
                                & near_ke[None, :]).astype(
                                    float)[..., None]
        self._z_row = np.asarray(g.zC).reshape(1, 1, 1, -1)
        # z-row shape (layout-independent: the distributed blocks share it)
        self._dz_row = np.asarray(g.dz(Center)).reshape(1, 1, 1, -1)

        # geographic coordinates on the full extended panel plane at the
        # three horizontal staggerings (the analytic panel-map extension
        # is exact in the halos)
        from oceananigans_tpu.grids.cubed_sphere_grid import (
            panel_geographic_coords,
        )

        def geo(xs, ys):
            lam, phi = panel_geographic_coords(xs, ys)
            return lam[..., None], phi[..., None]

        tC = -1.0 + d * (np.arange(nx) - H + 0.5)
        tF = -1.0 + d * (np.arange(nx) - H)
        self._lam_c, self._phi_c = geo(tC, tC)
        self._lam_u, self._phi_u = geo(tF, tC)
        self._lam_v, self._phi_v = geo(tC, tF)
        # back-compat name used by the distributed adapter (halo columns
        # zeroed; forcing tendencies are interior-masked anyway)
        if self.forcings:
            self._lam_full = self._lam_c * mc[None]
            self._phi_full = self._phi_c * mc[None]

        # --- immersed bathymetry: wet masks + wet-column depths --------
        # (reference ImmersedMultiRegionGrid, multi_region_grid.jl:190-198;
        # dense-mask design per SURVEY §7 — masked whole-array compute
        # instead of gather/scatter active-cell maps)
        self.bathymetry = bathymetry
        self._wet_c = self._wet_u = self._wet_v = self._wet_w = None
        self._Hu = self._Hv = self._Hc = None
        self._frac_c = self._frac_u = self._frac_v = None
        self._wet2_c = self._wet2_u = self._wet2_v = None
        kk = np.arange(g.shape[2]).reshape(1, 1, 1, -1)
        Hz, Nz = g.Hz, g.Nz
        kin = ((kk >= Hz) & (kk < Hz + Nz)).astype(float)
        from oceananigans_tpu.immersed import (
            GridFittedBoundary as _GFB,
        )
        if isinstance(bathymetry, _GFB):
            # arbitrary 3-D solid mask (reference ``GridFittedBoundary``,
            # ``grid_fitted_boundary.jl:9`` + ``multi_region_models.jl:44``):
            # mask(lam_deg, phi_deg, z) -> solid, or a (6, N, N, Nz)-class
            # array. Solid cells anywhere in the column are masked; the
            # free-slip bottom-mirror fill uses the bottom-most WET cell
            # of each column (mid-column solid pockets get that value as
            # the free-slip extension).
            m = bathymetry.mask
            zc = np.asarray(g.zC).reshape(1, 1, 1, -1)
            if callable(m):
                lam3 = self._lam_c                       # (6, nx, ny, 1)
                phi3 = self._phi_c
                solid = np.asarray(m(lam3, phi3, zc), float)
                solid = np.broadcast_to(solid, (6, nx, ny,
                                                g.shape[2])).copy()
            else:
                mv = np.asarray(m, float)
                solid = np.zeros((6, nx, ny, g.shape[2]))
                if mv.shape == (6, N, N, Nz):
                    solid[:, H:H + N, H:H + N, Hz:Hz + Nz] = mv
                elif mv.shape == (6, nx, ny, g.shape[2]):
                    solid = mv.copy()
                else:
                    raise ValueError(
                        f"GridFittedBoundary mask must be "
                        f"(6, {N}, {N}, {Nz}) or full-frame, got "
                        f"{mv.shape}")
                solid = np.asarray(cubed_sphere_halo_exchange(
                    jnp.asarray(solid), grid)) > 0.5
                solid = solid.astype(float)
            wet = 1.0 - np.clip(solid, 0.0, 1.0)
            # z-halo slots: below-domain halos must read DRY so the
            # bottom-cell indicator (bot_ind's roll from below) marks
            # the deepest wet cell of full-depth columns; above-surface
            # halos stay WET so the free-slip top mirror (_fill_z) is
            # not overwritten by the solid mirror (round-5 self-review
            # finding). NOTE: columns with several wet segments get one
            # bottom indicator per segment — bottom flux BCs then apply
            # at every solid-fluid lower interface, and callable BCs'
            # field_dependencies see the SUM over segments (use
            # single-segment masks with bottom BCs).
            wet[:, :, :, :Hz] = 0.0
            wet[:, :, :, Hz + Nz:] = 1.0
            self._frac_c = self._frac_u = self._frac_v = None
            self._wet_c = wet
            self._wet_u = wet * np.roll(wet, 1, axis=1)
            self._wet_v = wet * np.roll(wet, 1, axis=2)
            self._wet_w = wet * np.roll(wet, 1, axis=3)
            dzf = np.broadcast_to(np.asarray(g.dz(Center)),
                                  g.shape)[None]
            dzi = dzf * kin
            self._Hc = np.sum(self._wet_c * dzi, axis=3, keepdims=True)
            self._Hu = np.sum(self._wet_u * dzi, axis=3, keepdims=True)
            self._Hv = np.sum(self._wet_v * dzi, axis=3, keepdims=True)
            self._wet2_c = (self._Hc > 0).astype(float)
            self._wet2_u = (self._Hu > 0).astype(float)
            self._wet2_v = (self._Hv > 0).astype(float)
            top = (kk == Hz + Nz - 1).astype(float)
            self._top_c = top * self._wet2_c
            self._top_u = top * self._wet2_u
            self._top_v = top * self._wet2_v

            def bot_ind(w3):
                below = np.roll(w3, 1, axis=3)
                return w3 * (1.0 - below) * kin

            self._bot_c = bot_ind(self._wet_c)
            self._bot_u = bot_ind(self._wet_u)
            self._bot_v = bot_ind(self._wet_v)
            _corner_filter_setup(self, corner_filter)
            return
        if bathymetry is not None:
            from oceananigans_tpu.immersed import GridFittedBottom
            bot = bathymetry.bottom_height \
                if isinstance(bathymetry, GridFittedBottom) else bathymetry
            if callable(bot):
                bot_full = np.asarray(
                    bot(self._lam_c[..., 0], self._phi_c[..., 0])
                )[..., None]
            else:
                botv = np.asarray(bot)
                bot_full = np.zeros((6, nx, ny, 1))
                if botv.shape == (6, N, N):
                    bot_full[:, H:H + N, H:H + N, 0] = botv
                elif botv.shape == (6, nx, ny):
                    bot_full[..., 0] = botv
                elif botv.shape == (6, nx, ny, 1):
                    bot_full = botv.copy()
                else:
                    raise ValueError(
                        f"bathymetry array must be (6, {N}, {N}) or "
                        f"(6, {nx}, {ny}[, 1]), got {botv.shape}")
                # make the mask halo-consistent across the panel seams
                bot_full = np.asarray(cubed_sphere_halo_exchange(
                    jnp.asarray(bot_full), grid))
            zc = np.asarray(g.zC).reshape(1, 1, 1, -1)
            dzf = np.broadcast_to(np.asarray(g.dz(Center)),
                                  g.shape)[None]
            from oceananigans_tpu.immersed import (
                PartialCellBottom as _PCB,
            )
            if isinstance(bathymetry, _PCB):
                # partial bottom cells (reference
                # ``partial_cell_bottom.jl:11`` +
                # ``multi_region_models.jl:45``): the bottom-adjacent
                # cell keeps the actual water fraction of its height,
                # so gentle slopes avoid the staircase error
                zf = np.asarray(g.zF).reshape(1, 1, 1, -1)
                z_top = zf + dzf
                with np.errstate(invalid="ignore"):
                    water = np.clip((z_top - bot_full) / dzf, 0.0, 1.0)
                eps_min = bathymetry.minimum_fractional_cell_height
                wet = (water >= eps_min).astype(float)
                frac = np.where(wet > 0,
                                np.clip(water, eps_min, 1.0), 1.0)
                self._frac_c = frac
                # face thickness: the SHALLOWER of the two adjacent
                # partial cells (reference partial-cell Δzᶠᶜᶜ)
                self._frac_u = np.minimum(frac, np.roll(frac, 1, axis=1))
                self._frac_v = np.minimum(frac, np.roll(frac, 1, axis=2))
            else:
                wet = (zc >= bot_full).astype(float)
                self._frac_c = self._frac_u = self._frac_v = None
            self._wet_c = wet
            # a face is wet only when both adjacent cells are (face i
            # sits between cells i-1 and i)
            self._wet_u = wet * np.roll(wet, 1, axis=1)
            self._wet_v = wet * np.roll(wet, 1, axis=2)
            self._wet_w = wet * np.roll(wet, 1, axis=3)
            dzi = dzf * kin
            if self._frac_c is not None:
                self._Hc = np.sum(self._wet_c * self._frac_c * dzi,
                                  axis=3, keepdims=True)
                self._Hu = np.sum(self._wet_u * self._frac_u * dzi,
                                  axis=3, keepdims=True)
                self._Hv = np.sum(self._wet_v * self._frac_v * dzi,
                                  axis=3, keepdims=True)
            else:
                self._Hc = np.sum(self._wet_c * dzi, axis=3,
                                  keepdims=True)
                self._Hu = np.sum(self._wet_u * dzi, axis=3,
                                  keepdims=True)
                self._Hv = np.sum(self._wet_v * dzi, axis=3,
                                  keepdims=True)
            self._wet2_c = (self._Hc > 0).astype(float)
            self._wet2_u = (self._Hu > 0).astype(float)
            self._wet2_v = (self._Hv > 0).astype(float)
            # boundary-adjacent cell indicators for flux BCs: the surface
            # cell of each wet column; the bottom-most wet cell
            top = (kk == Hz + Nz - 1).astype(float)
            self._top_c = top * self._wet2_c
            self._top_u = top * self._wet2_u
            self._top_v = top * self._wet2_v

            def bot_ind(w3):
                below = np.roll(w3, 1, axis=3)
                return w3 * (1.0 - below) * kin

            self._bot_c = bot_ind(self._wet_c)
            self._bot_u = bot_ind(self._wet_u)
            self._bot_v = bot_ind(self._wet_v)
        else:
            top = (kk == Hz + Nz - 1).astype(float)
            bot = (kk == Hz).astype(float)
            self._top_c = self._top_u = self._top_v = top
            self._bot_c = self._bot_u = self._bot_v = bot
        #: optional corner-band filter (see _corner_filter_setup and the
        #: shallow-water model's note: long inviscid runs develop a
        #: nonlinear corner instability; 0.005 stabilizes without
        #: leaving the published error band). Off by default.
        _corner_filter_setup(self, corner_filter)

    # ------------------------------------------------------------------
    def initial_state(self, u=None, v=None, eta=0.0, time=0.0, **tracers):
        grid = self.grid
        g = grid.panel_grid
        nx, ny, nz = g.shape
        dtype = grid.new_field().dtype
        zero3 = jnp.zeros((6, nx, ny, nz), dtype)
        zero2 = jnp.zeros((6, nx, ny, 1), dtype)
        u = zero3 if u is None else jnp.asarray(u, dtype)
        v = zero3 if v is None else jnp.asarray(v, dtype)
        if jnp.ndim(eta) == 0:
            eta = jnp.full_like(zero2, eta) \
                * jnp.asarray(self._mask_c, dtype)
        tr = {}
        for name in self.tracer_names:
            val = tracers.get(name, 0.0)
            if callable(val):
                tr[name] = grid.set_tracer(val)
            elif jnp.ndim(val) == 0:
                tr[name] = jnp.full_like(zero3, val) \
                    * jnp.asarray(self._mask_c, dtype)
            else:
                tr[name] = jnp.asarray(val, dtype)
        ab2 = self.timestepper == "QuasiAdamsBashforth2"
        state = CubedSphereHydrostaticState(
            u=u, v=v, eta=jnp.asarray(eta, dtype), tracers=tr,
            clock=Clock.start(time=float(time), dtype=dtype),
            U=jnp.zeros_like(zero2), V=jnp.zeros_like(zero2),
            Gu=jnp.zeros_like(zero3) if ab2 else None,
            Gv=jnp.zeros_like(zero3) if ab2 else None,
            Geta=jnp.zeros_like(zero2) if ab2 else None,
            Gtracers={n: jnp.zeros_like(zero3)
                      for n in self.tracer_names} if ab2 else None)
        state = self.fill_state_halos(state)
        # persistent barotropic transports from the initial velocities
        # (reference initialize_free_surface!,
        # initialize_split_explicit_substepping.jl:15-25)
        if self._wet_u is not None:
            um = state.u * jnp.asarray(self._wet_u, dtype)
            vm = state.v * jnp.asarray(self._wet_v, dtype)
            mu = jnp.asarray(self._mask_u * self._wet2_u, dtype)
            mv = jnp.asarray(self._mask_v * self._wet2_v, dtype)
        else:
            um, vm = state.u, state.v
            mu = jnp.asarray(self._mask_u, dtype)
            mv = jnp.asarray(self._mask_v, dtype)
        su0 = sv0 = None
        if getattr(self, "_zstar", False):
            su0, sv0 = self._sigma_faces(state.eta)
        if self._frac_u is not None:
            fu0 = jnp.asarray(self._frac_u, dtype)
            fv0 = jnp.asarray(self._frac_v, dtype)
            su0 = fu0 if su0 is None else su0 * fu0
            sv0 = fv0 if sv0 is None else sv0 * fv0
        U0, V0 = cs_barotropic_mode(g, um, vm, su0, sv0)
        return dataclasses.replace(state, U=U0 * mu, V=V0 * mv)

    # ------------------------------------------------------------------
    def _mirror_solid(self, a, wet, bot_ind):
        """Fill the solid cells of each column with its bottom-most wet
        value: zero gradient across the immersed bottom, so vertical
        diffusive fluxes vanish there (the whole-array form of the
        reference's no-flux immersed conditions /
        ``conditional_differences.jl``) and velocities get a free-slip
        extension."""
        cbot = jnp.sum(a * jnp.asarray(bot_ind, a.dtype), axis=3,
                       keepdims=True)
        w = jnp.asarray(wet, a.dtype)
        return a * w + (1 - w) * cbot

    def fill_state_halos(self, state):
        grid = self.grid
        u, v = state.u, state.v
        if self._wet_u is not None:
            u = u * jnp.asarray(self._wet_u, u.dtype)
            v = v * jnp.asarray(self._wet_v, v.dtype)
        u, v = cubed_sphere_velocity_exchange(u, v, grid)
        u = self._fill_z(u)
        v = self._fill_z(v)
        eta = state.eta
        if self._wet2_c is not None:
            eta = eta * jnp.asarray(self._wet2_c, eta.dtype)
        eta = cubed_sphere_halo_exchange(eta, grid)
        tracers = {n: self._fill_z(cubed_sphere_halo_exchange(c, grid))
                   for n, c in state.tracers.items()}
        if self._wet_c is not None:
            u = self._mirror_solid(u, self._wet_u, self._bot_u)
            v = self._mirror_solid(v, self._wet_v, self._bot_v)
            tracers = {n: self._mirror_solid(c, self._wet_c, self._bot_c)
                       for n, c in tracers.items()}
        return dataclasses.replace(state, u=u, v=v, eta=eta,
                                   tracers=tracers)

    def _fill_z(self, a):
        """Mirror one z-ghost on each side (free-slip / no-flux)."""
        g = self.grid.panel_grid
        Hz, Nz = g.Hz, g.Nz
        if Hz == 0 or a.shape[-1] == 1:
            return a
        a = a.at[..., Hz - 1].set(a[..., Hz])
        a = a.at[..., Hz + Nz].set(a[..., Hz + Nz - 1])
        return a

    # ------------------------------------------------------------------
    def _sigma_field(self, eta):
        """z-star column stretching σ = (H + η)/H per column (σ = 1 on
        land columns); stacked (6, nx, ny, 1)."""
        if self._Hc is not None:
            H = jnp.asarray(self._Hc, eta.dtype)
        else:
            H = jnp.asarray(cs_column_depth(self.grid.panel_grid),
                            eta.dtype)
        Hs = jnp.where(H > 0, H, 1.0)
        return jnp.where(H > 0, 1.0 + eta / Hs, 1.0)

    def _sigma_faces(self, eta):
        """σ at the u/v faces from the face WET column depths (reference
        σᶠᶜⁿ/σᶜᶠⁿ from ``static_column_depthᶠᶜᵃ``,
        ``z_star_vertical_spacing.jl:44-75``): over bathymetry the face
        depth is the min of the adjacent columns', so interpolating the
        center σ would be inconsistent with the face flux areas."""
        if getattr(self, "_Hu", None) is not None:
            Hu = jnp.asarray(self._Hu, eta.dtype)
            Hv = jnp.asarray(self._Hv, eta.dtype)
        else:
            H = jnp.asarray(cs_column_depth(self.grid.panel_grid),
                            eta.dtype)
            Hu = Hv = H
        eu = jax.vmap(ix_f)(eta)
        ev = jax.vmap(iy_f)(eta)
        su = jnp.where(Hu > 0, 1.0 + eu / jnp.where(Hu > 0, Hu, 1.0), 1.0)
        sv = jnp.where(Hv > 0, 1.0 + ev / jnp.where(Hv > 0, Hv, 1.0), 1.0)
        return su, sv

    def _panel_w(self, u, v, g=None, wet_c=None):
        """w at z-faces from continuity (per panel); ``g`` overrides the
        panel grid (the σ-scaled view under ZStar, in which case this is
        the DIA-SURFACE velocity ω: the grid motion h(z)/H·H∂tσ is
        subtracted so ω vanishes at the moving surface — reference
        ``compute_w_from_continuity.jl`` z-star branch)."""
        # the grid-motion correction applies only under ACTUAL ZStar;
        # the METRIC-consistent flux divergence applies whenever the
        # panel view carries scaled thicknesses (ZStar σ and/or
        # partial-cell fractions) — with partial cells on the FIXED-z
        # coordinate the tracer fluxes use frac-scaled areas, so w must
        # integrate the same scaled divergence or a uniform tracer
        # develops anomalies at partial bottom cells (round-5
        # self-review finding)
        has_sigma = g is not None and hasattr(g, "sigma")
        scaled = has_sigma and getattr(self, "_zstar", False)
        if g is None:
            g = self.grid.panel_grid
        base = getattr(g, "base", g)
        if has_sigma:
            # thickness-CONSISTENT horizontal flux divergence (the same
            # scaled Ax/Ay areas the tracer fluxes use): only this form
            # makes the per-cell cancellation exact for flows with
            # vertical structure (the plain per-level form commutes the
            # scaling through δx, exact only for barotropic u)
            hdiv = (dx_c(g.Ax(Face, Center, Center) * u)
                    + dy_c(g.Ay(Center, Face, Center) * v)) \
                / g.V(Center, Center, Center)
        else:
            hdiv = (dx_c(g.dy(Center, Face) * u)
                    + dy_c(g.dx(Center, Face) * v)) / g.Az(Center, Center)
        dz = jnp.broadcast_to(g.dz(Center), base.shape)
        k = jnp.arange(base.shape[2]).reshape(1, 1, -1)
        interior = (k >= base.Hz) & (k < base.Hz + base.Nz)
        contrib = jnp.where(interior, hdiv * dz, 0.0)
        csum = jnp.cumsum(contrib, axis=2)
        w = -jnp.where(k == 0, 0.0,
                       jnp.roll(csum, 1, 2))
        if scaled:
            total = jnp.sum(contrib, axis=2, keepdims=True)
            dz0 = jnp.broadcast_to(base.dz(Center), base.shape)
            # WET thickness above the LOCAL bottom: the grid motion is
            # distributed over the wet part of each column only, so
            # ω = 0 at the immersed bottom face and the moving surface
            dz0w = jnp.where(interior, dz0, 0.0)
            if wet_c is not None:
                dz0w = dz0w * wet_c
            hb = jnp.roll(jnp.cumsum(dz0w, 2), 1, 2)
            hb = jnp.where(k == 0, 0.0, hb)
            H = jnp.sum(dz0w, axis=2, keepdims=True)
            w = w + jnp.where(H > 0, hb / jnp.where(H > 0, H, 1.0),
                              0.0) * total
        return w

    def _panel_transport_fluxes(self, u, v, wet_u=None, wet_v=None,
                                sigma=None, sigma_u=None, sigma_v=None):
        """Per-level horizontal transport fluxes (Ax·u, Ay·v) of one
        panel, wet-masked, on the (possibly) scaled metric view — the
        SAME areas the tracer fluxes use. The caller edge-SYNCS these
        before the continuity integral so ω and the (also synced)
        tracer fluxes see identical transports at panel seams: the
        per-cell cancellation that keeps uniform tracers uniform then
        holds exactly at edge columns too (round-5 refinement of the
        panel-local ω)."""
        g = self.grid.panel_grid
        if sigma is not None:
            from oceananigans_tpu.models.hydrostatic import _ScaledZGrid
            g = _ScaledZGrid(g, sigma, sigma_u, sigma_v)
        um = u if wet_u is None else u * wet_u
        vm = v if wet_v is None else v * wet_v
        return (g.Ax(Face, Center, Center) * um,
                g.Ay(Center, Face, Center) * vm)

    def _panel_w_from_fluxes(self, Fxl, Fyl, sigma=None, wet_c=None):
        """ω from edge-synced per-level transport fluxes: continuity
        cumsum (+ the z-star grid-motion correction when σ is a real
        moving-grid scaling)."""
        g = self.grid.panel_grid
        if sigma is not None:
            from oceananigans_tpu.models.hydrostatic import _ScaledZGrid
            g = _ScaledZGrid(g, sigma)
        base = getattr(g, "base", g)
        hdiv = (dx_c(Fxl) + dy_c(Fyl)) / g.V(Center, Center, Center)
        dz = jnp.broadcast_to(g.dz(Center), base.shape)
        k = jnp.arange(base.shape[2]).reshape(1, 1, -1)
        interior = (k >= base.Hz) & (k < base.Hz + base.Nz)
        contrib = jnp.where(interior, hdiv * dz, 0.0)
        csum = jnp.cumsum(contrib, axis=2)
        w = -jnp.where(k == 0, 0.0, jnp.roll(csum, 1, 2))
        if getattr(self, "_zstar", False):
            total = jnp.sum(contrib, axis=2, keepdims=True)
            dz0 = jnp.broadcast_to(base.dz(Center), base.shape)
            dz0w = jnp.where(interior, dz0, 0.0)
            if wet_c is not None:
                dz0w = dz0w * wet_c
            hb = jnp.roll(jnp.cumsum(dz0w, 2), 1, 2)
            hb = jnp.where(k == 0, 0.0, hb)
            H = jnp.sum(dz0w, axis=2, keepdims=True)
            w = w + jnp.where(H > 0, hb / jnp.where(H > 0, H, 1.0),
                              0.0) * total
        return w

    def _panel_pressure(self, b, g=None):
        """p′ = −∫_z^0 b dz′ at centers (per panel)."""
        if g is None:
            g = self.grid.panel_grid
        base = getattr(g, "base", g)
        dz = jnp.broadcast_to(g.dz(Center), base.shape)
        k = jnp.arange(base.shape[2]).reshape(1, 1, -1)
        interior = (k >= base.Hz) & (k < base.Hz + base.Nz)
        contrib = jnp.where(interior, b * dz, 0.0)
        total = jnp.sum(contrib, axis=2, keepdims=True)
        below_incl = jnp.cumsum(contrib, axis=2)
        return -((total - below_incl) + 0.5 * contrib)

    def _buoyancy_ccc(self, g, tracers):
        """Buoyancy at panel cell centers from this model's formulation
        (BuoyancyTracer / SeawaterBuoyancy / None)."""
        buoyancy = getattr(self, "buoyancy", None)
        if buoyancy is not None:
            return buoyancy.buoyancy_ccc(g, tracers)
        # distributed-view back-compat default: the 'b' tracer is
        # buoyancy when present
        b = tracers.get("b")
        return b

    def _panel_tendencies(self, u, v, eta, f_ff, zeta, tracers,
                          wet_u=None, wet_v=None, sigma=None,
                          sigma_u=None, sigma_v=None, wet_c=None,
                          sigma2d=None, w=None):
        g = self.grid.panel_grid
        if sigma is not None:
            from oceananigans_tpu.models.hydrostatic import _ScaledZGrid
            g = _ScaledZGrid(g, sigma, sigma_u, sigma_v)
        # transports/divergences use the wet-MASKED velocities (zero flux
        # through the immersed bottom); gradients and shear use the
        # mirrored fields the exchange produced (free-slip extension)
        um = u if wet_u is None else u * wet_u
        vm = v if wet_v is None else v * wet_v
        if w is None:
            w = self._panel_w(um, vm, g, wet_c)
        b = self._buoyancy_ccc(g, tracers)
        p = self._panel_pressure(b, g) if b is not None else 0.0
        # the distributed view namespaces default to the explicit form
        eta_term = (self.g * eta
                    if getattr(self, "_explicit_eta_grad", True) else 0.0)
        q = zeta + f_ff
        K = 0.5 * (ix_c(u * u) + iy_c(v * v))
        phi = K + p + eta_term
        from oceananigans_tpu.advection import (
            UpwindBiased, _face_value,
        )
        from oceananigans_tpu.ops.operators import dz_f, iz_c
        # hybrid upwinded (zeta + f) flux: first order in the
        # corner-adjacent region (scale-invariant conformal-corner
        # truncation needs the dissipation), 3rd-order elsewhere;
        # length-weighted transverse velocities
        Vu = ix_f(iy_c(g.dx(Center, Face) * vm)) / g.dx(Face, Center)
        Uv = iy_f(ix_c(g.dy(Center, Face) * um)) / g.dy(Face, Center)
        cm = jnp.asarray(self._corner_mask, q.dtype)
        ub3 = UpwindBiased(3)
        q1y = jnp.where(Vu >= 0, q, jnp.roll(q, -1, 1))
        q1x = jnp.where(Uv >= 0, q, jnp.roll(q, -1, 0))
        q_up = cm * q1y + (1 - cm) * _face_value(ub3, Vu, q, 1, 1)
        q_upx = cm * q1x + (1 - cm) * _face_value(ub3, Uv, q, 0, 1)
        dudz = dz_f(u) / g.dz(Face)
        Gu = q_up * Vu - dx_f(phi) / g.dx(Face, Center) \
            - iz_c(ix_f(w) * dudz)
        dvdz = dz_f(v) / g.dz(Face)
        Gv = -q_upx * Uv - dy_f(phi) / g.dy(Face, Center) \
            - iz_c(iy_f(w) * dvdz)
        # corner-band self-upwinded Bernoulli head (the root-cause fix
        # for the 3-valent-corner u² feedback; see
        # _corner_bernoulli_upwind_correction)
        cm_ke = jnp.asarray(getattr(self, "_corner_mask_ke",
                                    self._corner_mask), u.dtype)
        dGu_c, dGv_c = _corner_bernoulli_upwind_correction(g, u, v, K,
                                                           cm_ke)
        Gu = Gu + dGu_c
        Gv = Gv + dGv_c
        # σ-coordinate / partial-cell pressure-gradient correction
        # (reference ``grid_slope_contribution_x``,
        # z_star_vertical_spacing.jl:125-132): the p′ gradient at
        # constant k-level differs from the constant-z gradient by
        # b ∂x(z). Under ZStar z = σ z_ref + η; a partial bottom cell's
        # center additionally rises by (1 − frac)·Δz/2 (``sigma2d``
        # carries the z-star part alone so frac = sigma / sigma2d).
        slope_x = slope_y = None
        partial = sigma2d is not None and sigma2d is not sigma
        if (sigma is not None and b is not None
                and (getattr(self, "_zstar", False) or partial)):
            base = getattr(g, "base", g)
            zrow = jnp.asarray(base.zC, u.dtype).reshape(1, 1, -1)
            if partial:
                s2 = sigma2d
                frac3 = sigma / s2
                dz0 = jnp.asarray(base.dz(Center), u.dtype)
                zref = zrow + 0.5 * (1.0 - frac3) * dz0
            else:
                s2 = sigma
                zref = zrow
            z_c = s2 * zref + eta
            # sign: our p′ = −∫_z^0 b dz′ has ∂z p′ = +b, so
            # −(∂x p)_z = −(∂x p)_k + b ∂x(z) — the correction ADDS
            # b ∂x(z) (verified by the rest-over-slope test: the
            # opposite sign doubles the spurious flow)
            slope_x = ix_f(b) * dx_f(z_c) / g.dx(Face, Center)
            slope_y = iy_f(b) * dy_f(z_c) / g.dy(Face, Center)
            Gu = Gu + slope_x
            Gv = Gv + slope_y
        adv = getattr(self, "momentum_advection", None)
        if adv is None:
            return Gu, Gv, w
        # full vector-invariant option matrix (WENOVectorInvariant etc.)
        # away from the corner band, blended back to the robust hybrid
        # form inside it (reference regionalized VectorInvariant,
        # multi_region_models.jl:70-79 +
        # vector_invariant_advection.jl); the scheme consumes the
        # corner-circulation-fixed ζ, Coriolis keeps the
        # enstrophy-conserving transverse-averaged form
        Gu_adv = adv.u_tendency(g, u, v, w, zeta=zeta)
        Gv_adv = adv.v_tendency(g, u, v, w, zeta=zeta)
        phig = p + eta_term
        if not hasattr(phig, "ndim"):
            # no buoyancy pressure and the barotropic gradient lives in
            # the split/implicit machinery: nothing to differentiate
            phig = jnp.zeros_like(u)
        Gu_vi = Gu_adv + iy_c(f_ff) * Vu \
            - dx_f(phig) / g.dx(Face, Center)
        Gv_vi = Gv_adv - ix_c(f_ff) * Uv \
            - dy_f(phig) / g.dy(Face, Center)
        if slope_x is not None:
            Gu_vi = Gu_vi + slope_x
            Gv_vi = Gv_vi + slope_y
        Gu = cm * Gu + (1 - cm) * Gu_vi
        Gv = cm * Gv + (1 - cm) * Gv_vi
        return Gu, Gv, w

    def _panel_fluxes(self, u, v, w, tracers, wet_u=None, wet_v=None,
                      wet_w=None, sigma=None, sigma_u=None, sigma_v=None):
        """Barotropic + tracer fluxes (horizontal parts edge-synced by
        the caller). With immersed bathymetry, every advective flux
        through a solid face is zeroed (the reference's conditional
        immersed fluxes, ``immersed_advective_fluxes.jl``)."""
        from oceananigans_tpu.advection import _face_value, _scheme_for
        g = self.grid.panel_grid
        if sigma is not None:
            from oceananigans_tpu.models.hydrostatic import _ScaledZGrid
            g = _ScaledZGrid(g, sigma, sigma_u, sigma_v)
        base = getattr(g, "base", g)
        um = u if wet_u is None else u * wet_u
        vm = v if wet_v is None else v * wet_v
        dz = jnp.broadcast_to(g.dz(Center), base.shape)
        k = jnp.arange(base.shape[2]).reshape(1, 1, -1)
        interior = (k >= base.Hz) & (k < base.Hz + base.Nz)
        dzi = jnp.where(interior, dz, 0.0)
        # vertically integrated transports (for eta): the thickness at
        # each FACE carries that face's σ, exactly matching the column
        # sum of the tracer flux areas g.Ax/g.Ay below
        if sigma is not None and sigma_u is not None:
            dz0 = jnp.broadcast_to(base.dz(Center), base.shape)
            dzi0 = jnp.where(interior, dz0, 0.0)
            U = jnp.sum(um * (sigma_u * dzi0), axis=2, keepdims=True)
            V = jnp.sum(vm * (sigma_v * dzi0), axis=2, keepdims=True)
        else:
            U = jnp.sum(um * dzi, axis=2, keepdims=True)
            V = jnp.sum(vm * dzi, axis=2, keepdims=True)
        Fx = g.dy(Center, Face) * U
        Fy = g.dx(Center, Face) * V
        Ft = {}
        for name, c in tracers.items():
            sxs = _scheme_for(self.tracer_advection, 0)
            sys_ = _scheme_for(self.tracer_advection, 1)
            szs = _scheme_for(self.tracer_advection, 2)
            fcx = g.Ax(Face, Center, Center) * um \
                * _face_value(sxs, um, c, 0, 0)
            fcy = g.Ay(Center, Face, Center) * vm \
                * _face_value(sys_, vm, c, 1, 0)
            fcz = g.Az(Center, Center) * w \
                * _face_value(szs, w, c, 2, 0)
            # no flux through top/bottom walls
            wall = (k <= g.Hz) | (k > g.Hz + g.Nz - 1)
            fcz = jnp.where(wall, 0.0, fcz)
            if wet_w is not None:
                fcz = fcz * wet_w
            Ft[name] = (fcx, fcy, fcz)
        return Fx, Fy, Ft

    def _panel_divergences(self, Fx, Fy, Ft, sigma=None):
        from oceananigans_tpu.ops.operators import dz_c
        g = self.grid.panel_grid
        if sigma is not None:
            from oceananigans_tpu.models.hydrostatic import _ScaledZGrid
            g = _ScaledZGrid(g, sigma)
        Geta = -(dx_c(Fx) + dy_c(Fy)) \
            / g.Az(Center, Center)[:, :, :1]
        Gt = {}
        for name, (fcx, fcy, fcz) in Ft.items():
            Gt[name] = -(dx_c(fcx) + dy_c(fcy) + dz_c(fcz)) \
                / g.V(Center, Center, Center)
        return Geta, Gt

    # -- surface / bottom flux boundary conditions ---------------------
    def _boundary_indicator(self, name, side):
        tag = "u" if name == "u" else "v" if name == "v" else "c"
        return getattr(self, f"_{'top' if side == 'top' else 'bot'}_{tag}")

    def _boundary_value(self, state, name, side):
        """Boundary-adjacent interior value of a field (the surface cell
        or the bottom-most wet cell) as a (6, nx, ny, 1) array."""
        a = state.fields()[name]
        if a.shape[-1] == 1:
            return a
        ind = jnp.asarray(self._boundary_indicator(name, side), a.dtype)
        return jnp.sum(a * ind, axis=3, keepdims=True)

    def _eval_cs_flux(self, bc, name, side, state, t, dtype):
        """Evaluate a top/bottom FluxBC condition to a broadcastable
        (6, nx, ny, 1) array. Callables get
        ``f(lam_deg, phi_deg, t, *field_deps)`` with each dependency's
        boundary-adjacent value (reference
        ``continuous_boundary_function.jl`` + ``field_dependencies``)."""
        q = bc.condition
        if callable(q):
            tag = "u" if name == "u" else "v" if name == "v" else "c"
            lam = jnp.asarray(getattr(self, f"_lam_{tag}"), dtype)
            phi = jnp.asarray(getattr(self, f"_phi_{tag}"), dtype)
            deps = [self._boundary_value(state, dep, side)
                    for dep in bc.field_dependencies]
            q = q(lam, phi, t, *deps)
        q = jnp.asarray(q, dtype)
        if q.ndim == 3:
            q = q[..., None]
        g = self.grid.panel_grid
        if (q.ndim == 4 and q.shape[1] == self.grid.N_panel
                and q.shape[1] != g.shape[0]):
            # interior-shaped array -> embed in the halo frame (guard on
            # the FRAME size too: on the distributed block layout the
            # local frame can coincidentally equal N_panel)
            H, N = g.Hx, self.grid.N_panel
            full = jnp.zeros((q.shape[0], g.shape[0], g.shape[1], 1),
                             dtype)
            q = full.at[:, H:H + N, H:H + N, :].set(q)
        return q

    def _apply_cs_flux_bcs(self, state, Gu, Gv, Gt):
        """Add top/bottom boundary fluxes into the tendencies at the
        surface / bottom-most wet cell (reference ``apply_flux_bcs.jl``
        sign convention: a bottom [left] flux adds +q/Δz, a top [right]
        flux adds −q/Δz). Under ZStar the boundary cell's MOVING
        thickness is σΔz — dividing by it here means the σ-weighted
        tendency carries exactly q/Δz_ref, the conserved-content form
        (ADVICE r4: the static Δz overcounted by σ ≈ 1 + η/H)."""
        dtype = Gu.dtype
        dz = jnp.asarray(self._dz_row, dtype)
        t = state.clock.time
        if getattr(self, "_zstar", False):
            # the distributed adapter passes a namespace with fields()
            # only (no .eta attribute)
            eta_ = getattr(state, "eta", None)
            if eta_ is None:
                eta_ = state.fields()["eta"]
            sig_c = self._sigma_field(eta_)
            sig_u, sig_v = self._sigma_faces(eta_)
        else:
            sig_c = sig_u = sig_v = None
        for name, fbc in self.bcs.items():
            for side, sign in (("top", -1.0), ("bottom", 1.0)):
                bc = getattr(fbc, side, None)
                if bc is None or bc.condition is None:
                    continue
                q = self._eval_cs_flux(bc, name, side, state, t, dtype)
                ind = jnp.asarray(self._boundary_indicator(name, side),
                                  dtype)
                contrib = sign * q * ind / dz
                if sig_c is not None:
                    sig = sig_u if name == "u" else \
                        sig_v if name == "v" else sig_c
                    contrib = contrib / sig
                if getattr(self, "_frac_c", None) is not None:
                    # a PARTIAL bottom cell's thickness is frac·Δz
                    fr = self._frac_u if name == "u" else \
                        self._frac_v if name == "v" else self._frac_c
                    contrib = contrib / jnp.asarray(fr, dtype)
                if name == "u":
                    Gu = Gu + contrib
                elif name == "v":
                    Gv = Gv + contrib
                else:
                    Gt[name] = Gt[name] + contrib
        return Gu, Gv, Gt

    def compute_tendencies(self, state):
        g = self.grid.panel_grid
        dtype = state.u.dtype
        f = jnp.asarray(self.f_ff, dtype)
        zeta = jax.vmap(lambda up, vp: vorticity_z_ff(g, up, vp))(
            state.u, state.v)
        zeta = cubed_sphere_corner_vorticity(zeta, state.u, state.v,
                                             self.grid)
        zstar = getattr(self, "_zstar", False)
        sig = self._sigma_field(state.eta) if zstar else None
        if self._wet_u is None and not zstar:
            # edge-synced ω: the continuity integral uses the same
            # single-valued panel-seam transports as the tracer fluxes
            Fxl, Fyl = jax.vmap(self._panel_transport_fluxes)(
                state.u, state.v)
            Fxl, Fyl = cubed_sphere_sync_edge_fluxes(Fxl, Fyl,
                                                     self.grid)
            w = jax.vmap(self._panel_w_from_fluxes)(Fxl, Fyl)
            Gu, Gv, w = jax.vmap(self._panel_tendencies)(
                state.u, state.v, state.eta, f, zeta, state.tracers,
                None, None, None, None, None, None, None, w)
            Fx, Fy, Ft = jax.vmap(self._panel_fluxes)(
                state.u, state.v, w, state.tracers)
        else:
            # neutral (all-ones) masks keep the vmapped signatures
            # uniform; ×1.0 is bitwise exact
            ones2 = jnp.ones((6, 1, 1, 1), dtype)
            if self._wet_u is not None:
                wu = jnp.asarray(self._wet_u, dtype)
                wv = jnp.asarray(self._wet_v, dtype)
                ww = jnp.asarray(self._wet_w, dtype)
                wc = jnp.asarray(self._wet_c, dtype)
            else:
                wu = wv = ww = wc = ones2
            sg = sig if sig is not None else ones2
            if zstar:
                sgu, sgv = self._sigma_faces(state.eta)
            else:
                sgu = sgv = ones2
            sg2d = None
            if self._frac_c is not None:
                sg2d = sg
                # partial bottom cells: the STATIC height fractions ride
                # the same scaled-metric channel as the (time-varying)
                # z-star σ — the grid the dynamics see has thickness
                # frac·σ·dz. The continuity integral sees the fractional
                # thickness through wet_c·frac.
                sg = sg * jnp.asarray(self._frac_c, dtype)
                sgu = sgu * jnp.asarray(self._frac_u, dtype)
                sgv = sgv * jnp.asarray(self._frac_v, dtype)
                wc = wc * jnp.asarray(self._frac_c, dtype)
            # sg2d is None unless partial cells are active (vmap
            # carries the None through; the in-function sentinel is
            # `sigma2d is not None`)
            # edge-synced ω (see the plain branch)
            Fxl, Fyl = jax.vmap(self._panel_transport_fluxes)(
                state.u, state.v, wu, wv, sg, sgu, sgv)
            Fxl, Fyl = cubed_sphere_sync_edge_fluxes(Fxl, Fyl,
                                                     self.grid)
            w = jax.vmap(self._panel_w_from_fluxes)(Fxl, Fyl, sg, wc)
            Gu, Gv, w = jax.vmap(self._panel_tendencies)(
                state.u, state.v, state.eta, f, zeta, state.tracers,
                wu, wv, sg, sgu, sgv, wc, sg2d, w)
            Fx, Fy, Ft = jax.vmap(self._panel_fluxes)(
                state.u, state.v, w, state.tracers, wu, wv, ww, sg,
                sgu, sgv)
        Fx, Fy = cubed_sphere_sync_edge_fluxes(Fx, Fy, self.grid)
        Ft = {n: (*cubed_sphere_sync_edge_fluxes(fx_, fy_, self.grid),
                  fz_) for n, (fx_, fy_, fz_) in Ft.items()}
        if sig is None and self._frac_c is None:
            Geta, Gt = jax.vmap(self._panel_divergences)(Fx, Fy, Ft)
        else:
            # the divergence volume must carry the FULL per-cell
            # thickness factor (z-star σ × partial-cell frac) — the same
            # σ channel the fluxes were assembled with
            Geta, Gt = jax.vmap(self._panel_divergences)(Fx, Fy, Ft, sg)

        diffusivities = None
        if self.closure is not None:
            from oceananigans_tpu import closures as closures_mod
            g = self.grid.panel_grid

            def panel_closure(u, v, tracers, wet_u=None, wet_v=None,
                              wet_c=None):
                # w from the wet-masked transports; shear/diffusivities
                # from the mirrored fields (zero-gradient at the bottom);
                # diffusive FLUXES through solid faces are zeroed via the
                # solid-aware grid view (no coastal-wall leak)
                um = u if wet_u is None else u * wet_u
                vm = v if wet_v is None else v * wet_v
                w = self._panel_w(um, vm)
                gx = g if wet_c is None \
                    else _PanelSolidView(g, wet_c < 0.5)
                diff = closures_mod.compute_diffusivities(
                    self.closure, g, u, v, w, tracers,
                    self._closure_buoyancy)
                du, dv, _ = closures_mod.momentum_flux_divergences(
                    self.closure, gx, u, v, w, tracers, diff,
                    include_implicit=False)
                gt = {n: closures_mod.tracer_flux_divergence(
                    self.closure, gx, n, tracers[n], tracers, diff,
                    include_implicit=False) for n in tracers}
                # fully-implicit closures return scalar zeros here; vmap
                # needs array outputs
                du = du + jnp.zeros_like(u)
                dv = dv + jnp.zeros_like(v)
                gt = {n: t + jnp.zeros_like(tracers[n])
                      for n, t in gt.items()}
                return du, dv, gt, diff

            if self._wet_u is None:
                du, dv, gtc, diffusivities = jax.vmap(panel_closure)(
                    state.u, state.v, state.tracers)
            else:
                du, dv, gtc, diffusivities = jax.vmap(panel_closure)(
                    state.u, state.v, state.tracers,
                    jnp.asarray(self._wet_u, dtype),
                    jnp.asarray(self._wet_v, dtype),
                    jnp.asarray(self._wet_c, dtype))
            Gu = Gu + du
            Gv = Gv + dv
            Gt = {n: Gt[n] + gtc[n] for n in Gt}

        if self.forcings:
            t = state.clock.time
            for name, fn in self.forcings.items():
                if name == "u":
                    Gu = Gu + fn(jnp.asarray(self._lam_u, dtype),
                                 jnp.asarray(self._phi_u, dtype),
                                 self._z_row, t)
                elif name == "v":
                    Gv = Gv + fn(jnp.asarray(self._lam_v, dtype),
                                 jnp.asarray(self._phi_v, dtype),
                                 self._z_row, t)
                else:
                    Gt[name] = Gt[name] + fn(self._lam_full,
                                             self._phi_full,
                                             self._z_row, t)

        if self.bcs:
            Gu, Gv, Gt = self._apply_cs_flux_bcs(state, Gu, Gv, Gt)

        mu = jnp.asarray(self._mask_u, state.u.dtype)
        mv = jnp.asarray(self._mask_v, state.u.dtype)
        mc = jnp.asarray(self._mask_c, state.u.dtype)
        if self._wet_u is not None:
            mu = mu * jnp.asarray(self._wet_u, dtype)
            mv = mv * jnp.asarray(self._wet_v, dtype)
            mc2 = mc * jnp.asarray(self._wet2_c, dtype)
            mcw = mc * jnp.asarray(self._wet_c, dtype)
        else:
            mc2 = mcw = mc
        # z-interior indicator: tendencies must not accumulate in the z
        # halo levels (only one ghost level is re-mirrored per fill, so
        # un-masked halo tendencies would grow without bound)
        gz = self.grid.panel_grid
        k = jnp.arange(gz.shape[2])
        kin = ((k >= gz.Hz) & (k < gz.Hz + gz.Nz)).astype(state.u.dtype)
        kin = kin.reshape(1, 1, 1, -1)
        if self.prescribed_velocities:
            Gu = jnp.zeros_like(Gu)
            Gv = jnp.zeros_like(Gv)
            Geta = jnp.zeros_like(Geta)
        return (Gu * mu * kin, Gv * mv * kin, Geta * mc2,
                {n: G * mcw * kin for n, G in Gt.items()}, diffusivities)

    # ------------------------------------------------------------------
    def _euler_free_surface(self, s, u_e, v_e, Gu, Gv, Geta, dt,
                            sigma_u=None, sigma_v=None):
        """Free-surface part of one Euler substage: returns the stage
        (u, v, eta, U, V) after the configured barotropic treatment.
        Under ZStar ``sigma_u``/``sigma_v`` scale the transport
        thicknesses (the barotropic mode integrates σ dz)."""
        from oceananigans_tpu.models.hydrostatic import (
            ExplicitFreeSurface, ImplicitFreeSurface,
        )
        fs = self.free_surface
        g = self.grid.panel_grid
        grid = self.grid
        exchange_eta = lambda e: cubed_sphere_halo_exchange(e, grid)
        sync_fluxes = lambda Fx, Fy: cubed_sphere_sync_edge_fluxes(
            Fx, Fy, grid)
        if self.prescribed_velocities:
            return u_e, v_e, s.eta, s.U, s.V
        dtype = u_e.dtype
        # 2-D masks narrowed to wet (any-depth-ocean) faces/columns, and
        # wet face-column depths, under immersed bathymetry
        if self._wet2_u is not None:
            mask_u2 = self._mask_u * self._wet2_u
            mask_v2 = self._mask_v * self._wet2_v
            mask_c2 = self._mask_c * self._wet2_c
            Hu = jnp.asarray(self._Hu, dtype)
            Hv = jnp.asarray(self._Hv, dtype)
        else:
            mask_u2, mask_v2, mask_c2 = (self._mask_u, self._mask_v,
                                         self._mask_c)
            Hu = Hv = None
        mu = jnp.asarray(mask_u2, dtype)
        mv = jnp.asarray(mask_v2, dtype)
        # transports integrate the wet-masked velocities; with partial
        # bottom cells the 3-D fraction joins the mode weights while the
        # 2-D σ alone scales the (fraction-aware) column depths
        mode_u, mode_v = sigma_u, sigma_v
        frac_u = frac_v = None
        if getattr(self, "_frac_u", None) is not None:
            frac_u = jnp.asarray(self._frac_u, dtype)
            frac_v = jnp.asarray(self._frac_v, dtype)
            mode_u = frac_u if mode_u is None else mode_u * frac_u
            mode_v = frac_v if mode_v is None else mode_v * frac_v
        um = u_e if self._wet_u is None \
            else u_e * jnp.asarray(self._wet_u, dtype)
        vm = v_e if self._wet_v is None \
            else v_e * jnp.asarray(self._wet_v, dtype)
        if isinstance(fs, ExplicitFreeSurface):
            eta = s.eta + dt * Geta
            U, V = cs_barotropic_mode(g, um, vm, mode_u, mode_v)
            return u_e, v_e, eta, U * mu, V * mv
        if isinstance(fs, ImplicitFreeSurface):
            eta = cs_implicit_free_surface(
                g, um, vm, s.eta, dt, fs, exchange_eta, sync_fluxes,
                mask_c2, Hu=Hu, Hv=Hv)
            gx, gy = cs_eta_gradients(g, eta)
            u_e = u_e - dt * fs.g * gx * mu
            v_e = v_e - dt * fs.g * gy * mv
            um = u_e if self._wet_u is None \
                else u_e * jnp.asarray(self._wet_u, dtype)
            vm = v_e if self._wet_v is None \
                else v_e * jnp.asarray(self._wet_v, dtype)
            U, V = cs_barotropic_mode(g, um, vm, mode_u, mode_v)
            return u_e, v_e, eta, U * mu, V * mv
        # split-explicit barotropic substepping from the PERSISTENT
        # barotropic state (s.U, s.V), slow-forced by ∫ G dz
        # (Gu is already σ-weighted under ZStar, so GU = ∫ σ Gu frac dz)
        GU, GV = cs_barotropic_mode(g, Gu, Gv, frac_u, frac_v)
        eta_f, U_f, V_f = cs_split_explicit_free_surface(
            g, s.U, s.V, s.eta, GU, GV, dt, fs, exchange_eta,
            sync_fluxes, mask_u2, mask_v2, Hu=Hu, Hv=Hv)
        # correct the wet-masked velocities; the solid mirror is
        # restored by the next exchange
        u_c, v_c = cs_barotropic_correct(
            g, um, vm, U_f, V_f, mask_u2, mask_v2, Hu=Hu, Hv=Hv,
            sigma_u=mode_u, sigma_v=mode_v,
            depth_u=(sigma_u if sigma_u is not None
                     else jnp.ones((), dtype))
            if frac_u is not None else None,
            depth_v=(sigma_v if sigma_v is not None
                     else jnp.ones((), dtype))
            if frac_v is not None else None)
        if self._wet_u is not None:
            wu = jnp.asarray(self._wet_u, dtype)
            wv = jnp.asarray(self._wet_v, dtype)
            u_c = u_c * wu + u_e * (1 - wu)
            v_c = v_c * wv + v_e * (1 - wv)
        return u_c, v_c, eta_f, U_f, V_f

    def step(self, state, dt, assume_filled=False):
        if self.timestepper == "QuasiAdamsBashforth2":
            return self._ab2_step(state, dt, assume_filled=assume_filled)
        return self._rk3_step(state, dt, assume_filled=assume_filled)

    def _ab2_step(self, state, dt, chi=0.1, assume_filled=False):
        """χ-weighted quasi-AB2 step with a branch-free Euler first step
        (reference ``quasi_adams_bashforth_2.jl:74-175`` +
        ``hydrostatic_free_surface_ab2_step.jl``): the AB2-effective
        tendency drives the momentum/tracer update AND the barotropic
        machinery (slow forcing of the split-explicit substeps /
        explicit η step)."""
        from oceananigans_tpu import closures as closures_mod
        from oceananigans_tpu.timesteppers import ab2_coefficients
        dt = jnp.asarray(dt, state.u.dtype)
        s = state if assume_filled else self.fill_state_halos(state)
        c_now, c_prev = ab2_coefficients(s.clock.iteration, chi)
        Gu, Gv, Geta, Gt, diff = self.compute_tendencies(s)
        zstar = getattr(self, "_zstar", False)
        six_u = six_v = None
        if zstar:
            # store σ-WEIGHTED tendencies: only those telescope exactly
            # across the moving grid (reference
            # z_star_vertical_spacing.jl; flat-model _step_qab2). Face σ
            # from the face WET depths (σᶠᶜⁿ) — consistent with the flux
            # areas over bathymetry.
            sigma_n = self._sigma_field(s.eta)
            six_u, six_v = self._sigma_faces(s.eta)
            Gu = Gu * six_u
            Gv = Gv * six_v
            Gt = {n: Gt[n] * sigma_n for n in self.tracer_names}
        Gu_eff = c_now * Gu + c_prev * s.Gu
        Gv_eff = c_now * Gv + c_prev * s.Gv
        Geta_eff = c_now * Geta + c_prev * s.Geta
        Gt_eff = {n: c_now * Gt[n] + c_prev * s.Gtracers[n]
                  for n in self.tracer_names}
        if zstar:
            u_e = s.u + dt * Gu_eff / six_u
            v_e = s.v + dt * Gv_eff / six_v
        else:
            u_e = s.u + dt * Gu_eff
            v_e = s.v + dt * Gv_eff
        u, v, eta, U, V = self._euler_free_surface(
            s, u_e, v_e, Gu_eff, Gv_eff, Geta_eff, dt,
            sigma_u=six_u, sigma_v=six_v)
        if zstar:
            tracers = {n: s.tracers[n] + dt * Gt_eff[n] / sigma_n
                       for n in self.tracer_names}
            # grid update σⁿ -> σⁿ⁺¹: rescale so ∫ σ q dV is conserved
            sigma_np1 = self._sigma_field(eta)
            ratio = sigma_n / sigma_np1
            six_u1, six_v1 = self._sigma_faces(eta)
            u = u * (six_u / six_u1)
            v = v * (six_v / six_v1)
            tracers = {n: c * ratio for n, c in tracers.items()}
        else:
            tracers = {n: s.tracers[n] + dt * Gt_eff[n]
                       for n in self.tracer_names}
        if self.closure is not None and \
                closures_mod.closure_is_vertically_implicit(self.closure):
            g = self.grid.panel_grid

            def panel_implicit(uu, vv, tts, dd):
                return closures_mod.implicit_vertical_diffusion_step(
                    g, self.closure, dd, dt, u=uu, v=vv, tracers=tts)

            u, v, tracers = jax.vmap(panel_implicit)(u, v, tracers, diff)
        s = dataclasses.replace(
            s, u=u, v=v, eta=eta, U=U, V=V, tracers=tracers,
            Gu=Gu, Gv=Gv, Geta=Geta, Gtracers=Gt,
            clock=tick(s.clock, dt))
        s = self._apply_corner_filter(s)
        return self.fill_state_halos(s)

    def _rk3_step(self, state, dt, assume_filled=False):
        """SSP (Shu-Osher) RK3 with per-stage exchange; each stage is a
        full-Δt Euler substage (with its own free-surface treatment —
        explicit, split-explicit substepping, or implicit CG solve)
        convex-combined with Ψⁿ. Vertically-implicit closures get the
        per-stage column Thomas solve the rectilinear hydrostatic
        split-RK3 uses. ``assume_filled=True`` (Simulation's batched
        windows) skips the first stage's leading exchange — every step
        ends with one."""
        from oceananigans_tpu import closures as closures_mod
        dt = jnp.asarray(dt, state.u.dtype)
        psi = (state.u, state.v, state.eta,
               {n: state.tracers[n] for n in self.tracer_names},
               state.U, state.V)
        s = state
        implicit = self.closure is not None and \
            closures_mod.closure_is_vertically_implicit(self.closure)
        g = self.grid.panel_grid
        for stage, (gamma, zeta_c) in enumerate((
                (1.0, 0.0), (0.25, 0.75), (2.0 / 3.0, 1.0 / 3.0))):
            if stage > 0 or not assume_filled:
                s = self.fill_state_halos(s)
            Gu, Gv, Geta, Gt, diff = self.compute_tendencies(s)
            u_e = s.u + dt * Gu
            v_e = s.v + dt * Gv
            u_e, v_e, eta_e, U_e, V_e = self._euler_free_surface(
                s, u_e, v_e, Gu, Gv, Geta, dt)
            u = zeta_c * psi[0] + gamma * u_e
            v = zeta_c * psi[1] + gamma * v_e
            tracers = {n: zeta_c * psi[3][n]
                       + gamma * (s.tracers[n] + dt * Gt[n])
                       for n in self.tracer_names}
            if implicit:
                def panel_implicit(u, v, tracers, diff):
                    return closures_mod.implicit_vertical_diffusion_step(
                        g, self.closure, diff, gamma * dt, u=u, v=v,
                        tracers=tracers)
                u, v, tracers = jax.vmap(panel_implicit)(u, v, tracers,
                                                         diff)
            s = dataclasses.replace(
                s, u=u, v=v,
                eta=zeta_c * psi[2] + gamma * eta_e,
                U=zeta_c * psi[4] + gamma * U_e,
                V=zeta_c * psi[5] + gamma * V_e,
                tracers=tracers)
        s = dataclasses.replace(s, clock=tick(s.clock, dt))
        s = self._apply_corner_filter(s)
        return self.fill_state_halos(s)

    def _apply_corner_filter(self, s):
        if self.corner_filter is None or self.prescribed_velocities:
            return s
        # filter on FILLED halos (one-ring Laplacian taps), re-filled by
        # the caller's trailing exchange
        s = self.fill_state_halos(s)
        if self._wet_u is None:
            mu, mv = self._mask_u, self._mask_v
        else:
            # restrict to INTERIOR z-levels: the z-halo slots above the
            # terrain are spuriously "wet" (zc > land height), and the
            # smoother must not write velocity there (land stays dry)
            gz = self.grid.panel_grid
            kz = np.arange(gz.shape[2]).reshape(1, 1, 1, -1)
            kin_z = ((kz >= gz.Hz) & (kz < gz.Hz + gz.Nz)).astype(float)
            mu = self._mask_u * self._wet_u * kin_z
            mv = self._mask_v * self._wet_v * kin_z
        if getattr(self, "_zstar", False) or self._frac_c is not None:
            # ZStar / partial-cell composition: smooth the
            # THICKNESS-WEIGHTED content (σ·frac·c) and η itself (the σ
            # carrier), then unscale by the filtered thickness —
            # ∑ Az dz σ frac c and ∑ Az η both telescope exactly, so
            # the filter preserves the conservation laws
            one = jnp.ones((), s.eta.dtype)
            zs = getattr(self, "_zstar", False)
            sigma = self._sigma_field(s.eta) if zs else one
            if self._frac_c is not None:
                fr = jnp.asarray(self._frac_c, s.eta.dtype)
                sigma = sigma * fr
            eta_f = _corner_smooth_center(self, s.eta)
            sigma_f = self._sigma_field(eta_f) if zs else one
            if self._frac_c is not None:
                sigma_f = sigma_f * fr
            tracers = {n: _corner_smooth_center(self, c * sigma) / sigma_f
                       for n, c in s.tracers.items()}
            return dataclasses.replace(
                s,
                u=_corner_smooth_velocity(self, s.u, mu),
                v=_corner_smooth_velocity(self, s.v, mv),
                eta=eta_f, tracers=tracers)
        return dataclasses.replace(
            s,
            u=_corner_smooth_velocity(self, s.u, mu),
            v=_corner_smooth_velocity(self, s.v, mv),
            eta=_corner_smooth_center(self, s.eta),
            tracers={n: _corner_smooth_center(self, c)
                     for n, c in s.tracers.items()})

    # ------------------------------------------------------------------
    def cfl_timescale(self, state):
        """min(Δ/|u|) over panels — drives TimeStepWizard (reference
        ``cell_advection_timescale``)."""
        from oceananigans_tpu.advection import cell_advection_timescale
        g = self.grid.panel_grid

        def panel(u, v):
            w = self._panel_w(u, v)
            return cell_advection_timescale(g, u, v, w)

        return jnp.min(jax.vmap(panel)(state.u, state.v))

    # ------------------------------------------------------------------
    def total_volume(self, state):
        g = self.grid.panel_grid
        sx, sy, _ = g.interior_slices
        Az = g.Az(Center, Center)[sx, sy, :1]
        return jnp.sum(state.eta[:, sx, sy, :] * Az)

    def total_tracer(self, state, name):
        g = self.grid.panel_grid
        sx, sy, sz = g.interior_slices
        dV = (g.Az(Center, Center)[sx, sy, :1]
              * jnp.broadcast_to(g.dz(Center), g.shape)[sx, sy, sz])
        c = state.tracers[name][:, sx, sy, sz]
        if getattr(self, "_zstar", False):
            # the conserved content is ∫ σ c dV (the actual stretched
            # water column)
            c = c * self._sigma_field(state.eta)[:, sx, sy, :]
        if self._wet_c is not None:
            c = c * jnp.asarray(self._wet_c, c.dtype)[:, sx, sy, sz]
        if self._frac_c is not None:
            # partial bottom cells hold only their water fraction
            c = c * jnp.asarray(self._frac_c, c.dtype)[:, sx, sy, sz]
        return jnp.sum(c * dV)

    def ocean_volume(self):
        """Total wet volume (the conservation-budget denominator)."""
        g = self.grid.panel_grid
        sx, sy, sz = g.interior_slices
        dV = (g.Az(Center, Center)[sx, sy, :1]
              * jnp.broadcast_to(g.dz(Center), g.shape)[sx, sy, sz])
        if self._wet_c is None:
            return 6.0 * jnp.sum(dV)
        w = jnp.asarray(self._wet_c)[:, sx, sy, sz]
        if self._frac_c is not None:
            w = w * jnp.asarray(self._frac_c)[:, sx, sy, sz]
        return jnp.sum(w * dV)

    def __repr__(self):
        return (f"CubedSphereHydrostaticModel(N={self.grid.N_panel}, "
                f"Nz={self.grid.panel_grid.Nz})")


def cubed_sphere_partition(devices=None, R=1, panels=6):
    """Distribute the stacked panel axis — and, with ``R > 1``, an
    ``R x R`` within-panel block grid — over devices (the reference's
    ``CubedSpherePartition(R=...)``, ``cubed_sphere_partitions.jl:21-34``:
    Rx = Ry = R ranks per panel dimension, 6 R² total. There a
    rank-per-region MPI layout; here a ``("panel", "x", "y")`` ``Mesh``
    over the stacked array axes: the per-panel vmapped tendencies
    partition locally, the roll stencils become edge collective-permutes,
    and the inter-panel gather maps become GSPMD collectives
    automatically).

    ``panels``: how many ways to split the panel axis (divisor of 6; with
    fewer than ``6 R²`` devices pass e.g. ``panels=2`` so
    ``2 · R · R == len(devices)``).

    Returns ``(mesh, shard_state)`` where ``shard_state`` places every
    leading-6 array of a state pytree on the mesh."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    need = panels * R * R
    if devices is None:
        devices = jax.devices()[:need]
    if len(devices) != need:
        raise ValueError(f"cubed_sphere_partition(R={R}, panels={panels}) "
                         f"needs {need} devices (got {len(devices)})")
    if 6 % panels:
        raise ValueError(f"panels={panels} must divide 6")
    if R == 1 and panels == 6:
        mesh = Mesh(np.array(devices), ("panel",))
        spec = PartitionSpec("panel")
    else:
        mesh = Mesh(np.array(devices).reshape(panels, R, R),
                    ("panel", "x", "y"))
        spec = PartitionSpec("panel", "x", "y")
    sharding = NamedSharding(mesh, spec)

    def shard_state(tree):
        def put(x):
            if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == 6:
                return jax.device_put(x, sharding)
            return x
        return jax.tree_util.tree_map(put, tree)

    return mesh, shard_state
