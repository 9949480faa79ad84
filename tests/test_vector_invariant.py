"""VectorInvariant full option matrix (VERDICT r1 item 6; reference
``vector_invariant_advection.jl:36-63``, ``vector_invariant_self_upwinding
.jl``, ``vector_invariant_cross_upwinding.jl``): divergence-flux and
KE-gradient upwinding with OnlySelf/CrossAndSelf treatments, VelocityStencil
smoothness, and the flux-form vertical term."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oceananigans_tpu import (
    Bounded, Flat, LatitudeLongitudeGrid, Periodic, RectilinearGrid,
)
from oceananigans_tpu.advection import Centered, UpwindBiased, WENO
from oceananigans_tpu.models.hydrostatic import (
    CrossAndSelfUpwinding, ExplicitFreeSurface, HydrostaticFreeSurfaceModel,
    OnlySelfUpwinding, VectorInvariant, WENOVectorInvariant,
)


def _tendencies(vi, grid, u, v, w):
    return (np.asarray(vi.u_tendency(grid, u, v, w)),
            np.asarray(vi.v_tendency(grid, u, v, w)))


def _smooth_state(grid):
    """A smooth periodic 3-D velocity field on the grid's halo-extended
    arrays."""
    from oceananigans_tpu.fields import LOC_U, LOC_V, LOC_W, set_field

    def mk(loc, f):
        return set_field(grid, f, loc)

    u = mk(LOC_U, lambda x, y, z: np.sin(2 * np.pi * x)
           * np.cos(2 * np.pi * y) * (1 + 0.3 * np.cos(np.pi * z)))
    v = mk(LOC_V, lambda x, y, z: -np.cos(2 * np.pi * x)
           * np.sin(2 * np.pi * y) * (1 + 0.3 * np.cos(np.pi * z)))
    w = mk(LOC_W, lambda x, y, z: 0.1 * np.sin(2 * np.pi * x)
           * np.sin(np.pi * z))
    return u, v, w


def _grid(n, halo=6):
    return RectilinearGrid(size=(n, n, 8), x=(0, 1), y=(0, 1),
                           z=(-1, 0),
                           topology=(Periodic, Periodic, Bounded),
                           halo=halo)


def test_option_matrix_constructs_and_runs():
    """Every (vorticity, vertical, upwinding) combination of the
    reference option matrix builds and produces finite tendencies."""
    grid = _grid(16)
    u, v, w = _smooth_state(grid)
    vorticity_options = ["enstrophy_conserving", "energy_conserving",
                         UpwindBiased(3), WENO(5)]
    vertical_options = ["energy_conserving", Centered(2), UpwindBiased(3),
                        WENO(5)]
    upwinding_options = [OnlySelfUpwinding(), CrossAndSelfUpwinding(),
                         OnlySelfUpwinding(cross_scheme=Centered(4))]
    for zs, vs, up in itertools.product(vorticity_options,
                                        vertical_options,
                                        upwinding_options):
        if isinstance(vs, Centered):
            # centered schemes are symmetric: valid for the vertical
            # term but not for the divergence flux; the constructor
            # keeps the conserving KE form then
            vi = VectorInvariant(vorticity_scheme=zs, vertical_scheme=vs,
                                 divergence_scheme=UpwindBiased(3),
                                 upwinding=up)
        else:
            vi = VectorInvariant(vorticity_scheme=zs, vertical_scheme=vs,
                                 upwinding=up)
        gu, gv = _tendencies(vi, grid, u, v, w)
        assert np.isfinite(gu).all() and np.isfinite(gv).all(), (zs, vs, up)


def test_required_halo_matches_reference_rule():
    """required_halo = max(scheme halos) + 1 when any scheme has halo > 1
    (reference required_halo_size_x, vector_invariant_advection.jl:244-252).
    """
    assert VectorInvariant().required_halo == 2
    assert WENOVectorInvariant(5).required_halo == 4   # WENO-5 B=3, +1
    assert WENOVectorInvariant(5, vertical_order=3).required_halo == 4
    assert VectorInvariant(vorticity_scheme=UpwindBiased(3)).required_halo \
        == 3
    vi = WENOVectorInvariant()  # reference defaults: vorticity 9 → B=5
    assert vi.vorticity_scheme.order == 9
    assert vi.vertical_scheme.order == 5
    assert vi.required_halo == 6


def test_upwinded_forms_converge_to_conserving_on_smooth_flow():
    """On a smooth resolved flow the fully-upwinded formulation must
    converge to the energy-conserving formulation as the grid refines
    (they discretize the same PDE terms)."""
    errs = []
    for n in (16, 32):
        grid = _grid(n)
        u, v, w = _smooth_state(grid)
        ec = VectorInvariant(vertical_scheme="energy_conserving")
        up = VectorInvariant(vorticity_scheme=WENO(5),
                             vertical_scheme=WENO(5))
        gu0, gv0 = _tendencies(ec, grid, u, v, w)
        gu1, gv1 = _tendencies(up, grid, u, v, w)
        sx, sy, sz = grid.interior_slices
        d = np.abs(gu1 - gu0)[sx, sy, sz].max()
        scale = np.abs(gu0[sx, sy, sz]).max()
        errs.append(d / scale)
    assert errs[0] < 0.35
    assert errs[1] < 0.6 * errs[0]  # converging


def test_cross_upwinding_divergence_flux_vanishes_for_solenoidal_flow():
    """With CrossAndSelfUpwinding the divergence flux reconstructs
    δx(Ax u) + δy(Ay v) as one quantity — identically zero for a
    discretely divergence-free horizontal flow, so the upwinded vertical
    term must equal the plain flux-form vertical advection."""
    grid = _grid(16)
    u, v, w = _smooth_state(grid)
    # make (u, v) discretely non-divergent via a streamfunction on corners
    from oceananigans_tpu.fields import set_field
    from oceananigans_tpu.grids.base import Center, Face
    psi = set_field(grid,
                    lambda x, y, z: np.sin(2 * np.pi * x)
                    * np.sin(2 * np.pi * y),
                    (Face, Face, Center))
    from oceananigans_tpu.ops.operators import dy_c as _dy_c, dx_c as _dx_c
    # u = +δy ψ / Δy, v = −δx ψ / Δx  (discrete curl)
    u2 = _dy_c(psi) / grid.dy(Face, Center)
    v2 = -_dx_c(psi) / grid.dx(Center, Face)
    dxU = _dx_c(grid.Ax(Face, Center, Center) * u2)
    dyV = _dy_c(grid.Ay(Center, Face, Center) * v2)
    sx, sy, sz = grid.interior_slices
    div = np.asarray((dxU + dyV)[sx, sy, sz])
    assert np.abs(div).max() < 1e-5 * np.abs(np.asarray(dxU)).max()

    w0 = jnp.zeros_like(w)
    cross = VectorInvariant(vorticity_scheme=WENO(5),
                            vertical_scheme=WENO(5),
                            upwinding=CrossAndSelfUpwinding())
    got = np.asarray(cross._vertical_u(grid, u2, v2, w0))[sx, sy, sz]
    # with w = 0 and zero divergence flux the whole term must vanish
    assert np.abs(got).max() < 1e-5


def test_velocity_stencil_changes_weights_not_convergence():
    """VelocityStencil vs DefaultStencil give different nonlinear weights
    (different results on rough data) but identical reconstructions on
    smooth data up to the linear-weight limit."""
    grid = _grid(16)
    u, v, w = _smooth_state(grid)
    vel = VectorInvariant(vorticity_scheme=WENO(5),
                          vorticity_stencil="velocity")
    def_ = VectorInvariant(vorticity_scheme=WENO(5),
                           vorticity_stencil="default")
    gu_v, _ = _tendencies(vel, grid, u, v, w)
    gu_d, _ = _tendencies(def_, grid, u, v, w)
    sx, sy, sz = grid.interior_slices
    scale = np.abs(gu_v[sx, sy, sz]).max()
    # close on smooth flow
    assert np.abs(gu_v - gu_d)[sx, sy, sz].max() < 0.05 * scale
    # but not bitwise identical (different smoothness measures)
    assert np.abs(gu_v - gu_d)[sx, sy, sz].max() > 0


def test_latlon_jet_no_spurious_mixing():
    """A zonal jet on the sphere advected by the fully-upwinded
    WENOVectorInvariant must not spuriously accelerate: max|u| stays
    bounded by its initial value plus a small tolerance (VERDICT item 6
    'no-spurious-mixing test on the lat-lon sphere')."""
    from oceananigans_tpu.coriolis import HydrostaticSphericalCoriolis

    grid = LatitudeLongitudeGrid(size=(36, 16, 4), longitude=(0, 360),
                                 latitude=(20, 70), z=(-1000, 0),
                                 halo=6)
    model = HydrostaticFreeSurfaceModel(
        grid=grid,
        momentum_advection=WENOVectorInvariant(5),
        free_surface=ExplicitFreeSurface(),
        coriolis=HydrostaticSphericalCoriolis())
    state = model.initial_state(
        u=lambda lam, phi, z: 0.5 / np.cosh((phi - 45) / 8) ** 2)
    u0 = float(jnp.max(jnp.abs(state.u)))
    step = jax.jit(lambda s: model.step(s, 60.0))
    s = state
    for _ in range(100):
        s = step(s)
    s = jax.block_until_ready(s)
    u1 = np.asarray(grid.interior(s.u))
    assert np.isfinite(u1).all()
    assert np.abs(u1).max() < 1.3 * u0


def test_multi_dimensional_stencil_smooth_agreement():
    """multi_dimensional_stencil=True (reference 2-D horizontal WENO
    filter) must agree with the 1-D stencil on smooth flows to the
    filter's truncation order, and preserve constants exactly."""
    from oceananigans_tpu.advection import multi_dimensional_filter
    from oceananigans_tpu.boundary_conditions import (
        fill_halo_regions, regularize_field_boundary_conditions,
    )
    from oceananigans_tpu.fields import LOC_U, LOC_V, LOC_W, set_field

    # constant preservation of the raw filter (weights sum to one)
    q = jnp.full((6, 16, 2), 2.5)
    assert float(jnp.abs(multi_dimensional_filter(q, 1) - 2.5).max()) < 1e-14

    devs = []
    for N in (16, 32):
        grid = RectilinearGrid(size=(N, N, 4), extent=(1.0, 1.0, 1.0),
                               topology=(Periodic, Periodic, Bounded),
                               halo=6)
        u = set_field(grid, lambda x, y, z:
                      jnp.sin(2 * np.pi * x) * jnp.cos(2 * np.pi * y),
                      loc=LOC_U)
        v = set_field(grid, lambda x, y, z:
                      jnp.cos(2 * np.pi * x) * jnp.sin(2 * np.pi * y),
                      loc=LOC_V)
        w = set_field(grid, lambda x, y, z: 0.0, loc=LOC_W)
        bcs_u = regularize_field_boundary_conditions(None, grid, LOC_U)
        bcs_v = regularize_field_boundary_conditions(None, grid, LOC_V)
        u = fill_halo_regions(u, grid, bcs_u, LOC_U)
        v = fill_halo_regions(v, grid, bcs_v, LOC_V)
        w = fill_halo_regions(w, grid,
                              regularize_field_boundary_conditions(
                                  None, grid, LOC_W), LOC_W)
        one_d = WENOVectorInvariant(order=5)
        two_d = WENOVectorInvariant(order=5, multi_dimensional_stencil=True)
        S = grid.interior_slices
        g1 = np.asarray(one_d.u_tendency(grid, u, v, w)[S])
        g2 = np.asarray(two_d.u_tendency(grid, u, v, w)[S])
        scale = np.abs(g1).max()
        devs.append(np.abs(g2 - g1).max() / scale)
    assert devs[0] < 0.05, devs
    # the 2-D filter converges to the 1-D value with resolution
    assert devs[1] < 0.5 * devs[0], devs


def test_weno_z_weights_no_float32_overflow_nan():
    """float32 WENOVectorInvariant on a lat-lon grid must not NaN.

    The WENO-Z ratio tau/(beta+eps) reaches ~1e22 when smoothness is
    measured on the dimensional divergence flux (dxU ~ Ax*u ~ 1e7, so
    beta ~ 1e14 while eps = 1e-8); squaring overflowed float32 to inf
    and the weight normalization returned inf/inf = NaN (caught on an
    accelerator by the float32 hydro_vi smoke case). The reference never
    sees this because it defaults to Float64; the capped form in
    WENO._z_alphas keeps non-extreme weights bit-identical."""
    grid = LatitudeLongitudeGrid(size=(48, 32, 8), longitude=(-30.0, 30.0),
                                 latitude=(15.0, 55.0), z=(-1000.0, 0.0),
                                 halo=6, dtype="float32")
    model = HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=WENOVectorInvariant(),
        free_surface=ExplicitFreeSurface())
    state = model.initial_state(
        u=lambda lam, phi, z: 0.5 * np.cos(np.deg2rad(phi)) + 0 * lam,
        eta=lambda lam, phi: 0.05 * np.sin(np.deg2rad(lam) * 6))
    step = jax.jit(lambda s: model.step(s, jnp.float32(30.0)))
    s = state
    for _ in range(5):
        s = step(s)
    u = np.asarray(s.u)
    assert np.isfinite(u).all(), "float32 WENO-Z weights overflowed"
    assert np.abs(u).max() < 1.0
