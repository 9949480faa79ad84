"""NonhydrostaticModel: incompressible Boussinesq dynamics with a
pressure-projection method.

Reference: ``src/Models/NonhydrostaticModels/`` (SURVEY.md §2.14) — struct
and constructor ``nonhydrostatic_model.jl:32-239``, tendency kernels
``nonhydrostatic_tendency_kernel_functions.jl:47-78``, projection
``solve_for_pressure.jl:78-90`` + ``pressure_correction.jl:31-50``, state
update ``update_nonhydrostatic_model_state.jl:20-57``.

Design: the model object is a lightweight pytree (grid as child,
physics configuration as static metadata); the state is a flat pytree of
halo-extended arrays; ``step(state, dt)`` is a pure function containing the
whole AB2/RK3 + projection cycle, jit-compiled once. There are no kernel
launches, no mutation, no data-dependent branching — the AB2 Euler first
step is a ``where`` on the iteration counter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from oceananigans_tpu import closures as closures_mod
from oceananigans_tpu.advection import (
    Centered, cell_advection_timescale, div_Uc, div_vu, div_vv, div_vw,
    required_halo as advection_required_halo,
)
from oceananigans_tpu.boundary_conditions import (
    apply_flux_bcs, fill_halo_regions,
    regularize_field_boundary_conditions,
)
from oceananigans_tpu.buoyancy import regularize_buoyancy
from oceananigans_tpu.fields import LOC_C, LOC_U, LOC_V, LOC_W, new_field, set_field
from oceananigans_tpu.forcings import materialize_forcing
from oceananigans_tpu.grids.base import Center
from oceananigans_tpu.ops.operators import (
    ddx_f, ddy_f, ddz_f, divergence_ccc, dx_f, dy_f, dz_f,
)
from oceananigans_tpu.solvers.pressure_solver import make_pressure_solver
from oceananigans_tpu.timesteppers import (
    Clock, RK3_STAGES, ab2_coefficients, tick,
)

__all__ = ["NonhydrostaticModel", "NonhydrostaticState"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NonhydrostaticState:
    """The prognostic + diagnostic state pytree.

    ``G_`` fields hold the previous tendencies required by quasi-AB2
    restart continuity (reference ``checkpointer.jl:20-26``); for RK3 they
    hold the previous stage's tendencies within a step.
    """
    u: jnp.ndarray
    v: jnp.ndarray
    w: jnp.ndarray
    tracers: Dict[str, jnp.ndarray]
    pressure: jnp.ndarray
    clock: Clock
    Gu: jnp.ndarray
    Gv: jnp.ndarray
    Gw: jnp.ndarray
    Gtracers: Dict[str, jnp.ndarray]
    particles: Optional[Any] = None

    @property
    def velocities(self):
        return {"u": self.u, "v": self.v, "w": self.w}

    def fields(self):
        return {"u": self.u, "v": self.v, "w": self.w, **self.tracers}


def _replace(state, **kw):
    return dataclasses.replace(state, **kw)


class NonhydrostaticModel:
    """Configuration + pure step functions.

    Construction mirrors the reference's keyword surface
    (``nonhydrostatic_model.jl:114``): grid, advection, tracers, buoyancy,
    coriolis, closure, forcing, boundary_conditions, timestepper.
    """

    def __init__(self, grid, advection=None, tracers=(),
                 buoyancy=None, coriolis=None, closure=None,
                 forcing=None, boundary_conditions=None,
                 background_fields=None, particles=None,
                 stokes_drift=None, biogeochemistry=None,
                 timestepper="RungeKutta3"):
        self.particles = particles
        self.stokes_drift = stokes_drift
        self.biogeochemistry = biogeochemistry
        # background velocity/tracer *functions* f(x, y, z) for mean-flow
        # decomposition (reference background_fields.jl; used
        # nonhydrostatic_model.jl:220)
        self.background_fields = dict(background_fields or {})
        if advection is None:
            advection = Centered(2)
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        if biogeochemistry is not None:
            for t in biogeochemistry.required_tracers:
                if t not in tracers:
                    tracers = tracers + (t,)
        buoyancy = regularize_buoyancy(buoyancy)
        if buoyancy is not None:
            for t in buoyancy.required_tracers:
                if t not in tracers:
                    tracers = tracers + (t,)
        for cl in closures_mod._as_tuple(closure):
            for t in getattr(cl, "required_tracers", ()):
                if t not in tracers:
                    tracers = tracers + (t,)

        # halo requirement check (reference inflate_grid_halo_size,
        # nonhydrostatic_model.jl:243-257 — we validate rather than rebuild).
        # Periodic axes may run with NO halos at all: jnp.roll wraps exactly
        # with H=0 (a memory/bandwidth win over the reference's
        # always-haloed storage). But 0 < H < needed is INVALID on periodic
        # axes too: rolls then wrap through partially-stale halo cells.
        from oceananigans_tpu.grids.base import Periodic as _Periodic
        needed = max(advection_required_halo(advection),
                     closures_mod.closure_required_halo(closure))
        for axis in range(3):
            H = grid.H[axis]
            if grid.N[axis] <= 1:
                continue
            if grid.axis_topo(axis) == _Periodic and H == 0:
                continue
            if H < min(needed, grid.N[axis]):
                raise ValueError(
                    f"grid halo {grid.H} too small for advection/closure "
                    f"requiring {needed}; build the grid with halo={needed} "
                    f"(or halo=0 on periodic axes)")

        self.grid = grid
        # bind per-face stretched-grid reconstruction tables (no-op on
        # regular grids); o=0 targets are tabulated, o=1 falls back to
        # uniform coefficients
        b = getattr(advection, "bind_grid", None)
        self.advection = b(grid) if b is not None else advection
        self.tracer_names = tracers
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.closure = closure
        self.timestepper = timestepper

        # boundary conditions per field, regularized against topology
        boundary_conditions = dict(boundary_conditions or {})
        locs = {"u": LOC_U, "v": LOC_V, "w": LOC_W}
        self.locations = {**locs, **{t: LOC_C for t in tracers}}
        self.bcs = {}
        for name, loc in self.locations.items():
            self.bcs[name] = regularize_field_boundary_conditions(
                boundary_conditions.get(name), grid, loc)
        self.pressure_bcs = regularize_field_boundary_conditions(
            None, grid, LOC_C)

        # per-interface immersed boundary conditions (reference
        # ImmersedBoundaryCondition) + the scalar diffusivity their
        # Value/Gradient fluxes use
        from oceananigans_tpu.immersed import (
            ImmersedBoundaryGrid, regularize_immersed_bc,
            scalar_diffusivity_of,
        )
        self.immersed_bcs = {}
        if isinstance(grid, ImmersedBoundaryGrid):
            for name, loc in self.locations.items():
                rib = regularize_immersed_bc(self.bcs[name].immersed, loc)
                if rib is not None:
                    self.immersed_bcs[name] = rib
        self._ib_kappa = {
            name: scalar_diffusivity_of(
                closure, None if name in ("u", "v", "w") else name)
            for name in self.immersed_bcs}

        # forcings -> callables (grid, time, fields) -> array;
        # AdvectiveForcing entries are split out and summed into the
        # advecting velocity of the forced tracer (reference
        # with_advective_forcing, advective_forcing.jl:74-90)
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

        self.pressure_solver = make_pressure_solver(grid)
        # TendencyCallsite hooks: pure (grid, state, {name: G}) -> {name:
        # G} functions traced into compute_tendencies (the functional
        # analog of the reference's Gⁿ-mutating callbacks; wired by
        # Simulation for Callback(callsite=TendencyCallsite))
        self.tendency_callbacks = ()

    # -- pytree protocol: grid is a child, config is aux ------------------
    def tree_flatten(self):
        return (self.grid,), _ModelAux(self)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.__dict__.update(aux.d)
        obj.grid = children[0]
        return obj

    # ---------------------------------------------------------------------
    # State construction (the functional `set!`)
    # ---------------------------------------------------------------------
    def initial_state(self, time=0.0, **field_values):
        g = self.grid
        dtype = g.xC.dtype
        allowed = {"u", "v", "w"} | set(self.tracer_names)
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
        w = mk("w", LOC_W)
        tracers = {t: mk(t, LOC_C) for t in self.tracer_names}
        state = NonhydrostaticState(
            u=u, v=v, w=w, tracers=tracers,
            pressure=new_field(g, dtype),
            clock=Clock.start(time, dtype),
            Gu=new_field(g, dtype), Gv=new_field(g, dtype),
            Gw=new_field(g, dtype),
            Gtracers={t: new_field(g, dtype) for t in self.tracer_names},
            particles=(self.particles.initial
                       if self.particles is not None else None),
        )
        # construction-time update_state (reference
        # nonhydrostatic_model.jl:236): fill halos, project the initial
        # velocity onto the divergence-free subspace so u₀ is admissible.
        # Jitted: one dispatch instead of many small eager ones.
        @jax.jit
        def _project(s):
            s = self.fill_state_halos(s)
            s = self._pressure_correct(s, 1.0)
            return self.fill_state_halos(s)

        return _project(state)

    # ---------------------------------------------------------------------
    # update_state: halo fills (reference update_nonhydrostatic_model_state)
    # ---------------------------------------------------------------------
    def _fill_field(self, a, bcs, loc, t, dt=None):
        """Halo fill, routed through the distributed ppermute exchange
        when this model runs inside the explicit-halo shard_map step
        (parallel/shard_step.py sets ``dist_halo``)."""
        ctx = getattr(self, "dist_halo", None)
        if ctx is not None:
            from oceananigans_tpu.parallel.shard_step import dist_fill_halos
            return dist_fill_halos(a, self.grid, bcs, loc, t, dt, ctx,
                                   self.dist_topo)
        return fill_halo_regions(a, self.grid, bcs, loc, t, dt=dt)

    def _fill_before_projection(self, state):
        """Fill only the halos ``_pressure_correct`` reads.

        The divergence source term shifts each velocity component along
        its OWN axis only (``divergence_ccc``), so before the projection
        just the normal-component halos of haloed axes need filling —
        u in x, v in y, w in z (halo-free periodic axes wrap exactly via
        roll). Saves two of the three full-field fills per step in the
        default layout. Immersed/distributed/zipper configurations keep
        the full fill (masking and fold coupling touch everything)."""
        from oceananigans_tpu.immersed import ImmersedBoundaryGrid
        g = self.grid
        if (isinstance(g, ImmersedBoundaryGrid)
                or getattr(self, "dist_halo", None) is not None
                or getattr(g, "zipper", False)):
            return self.fill_state_halos(state)
        t = state.clock.time
        dtl = state.clock.last_dt
        upd = {}
        for axis, name, loc in ((0, "u", LOC_U), (1, "v", LOC_V),
                                (2, "w", LOC_W)):
            if g.H[axis] == 0:
                continue
            field = getattr(state, name)
            upd[name] = fill_halo_regions(field, g, self.bcs[name], loc,
                                          t, dt=dtl, axes=(axis,))
        return _replace(state, **upd) if upd else state

    def _eval_background(self, fn, loc, t):
        """Materialize one background field at clock time ``t``:
        ``BackgroundField`` / 4-arg callables get ``f(x, y, z, t)``
        (reference ``background_fields.jl:52-58``); 3-arg callables and
        arrays keep the static ``set_field`` semantics."""
        from oceananigans_tpu.fields import (
            BackgroundField, location_coords,
        )
        g = self.grid
        dtype = g.xC.dtype

        def eval4(f):
            x, y, z = location_coords(g, loc)
            return jnp.broadcast_to(
                jnp.asarray(f(x, y, z, t), dtype), g.shape)

        if isinstance(fn, BackgroundField):
            return eval4(fn)
        if callable(fn):
            import inspect
            try:
                n = len(inspect.signature(fn).parameters)
            except (TypeError, ValueError):
                n = 3
            if n >= 4:
                return eval4(fn)
        return set_field(g, fn, loc=loc)

    def fill_state_halos(self, state):
        from oceananigans_tpu.immersed import mask_immersed_field
        t = state.clock.time
        # mask solid regions first (reference mask_immersed_field!,
        # update_nonhydrostatic_model_state.jl:22-25), then fill halos
        u = mask_immersed_field(self.grid, state.u, LOC_U)
        v = mask_immersed_field(self.grid, state.v, LOC_V)
        w = mask_immersed_field(self.grid, state.w, LOC_W)
        dtl = state.clock.last_dt
        u = self._fill_field(u, self.bcs["u"], LOC_U, t, dt=dtl)
        v = self._fill_field(v, self.bcs["v"], LOC_V, t, dt=dtl)
        w = self._fill_field(w, self.bcs["w"], LOC_W, t, dt=dtl)
        tracers = {
            name: self._fill_field(c, self.bcs[name], LOC_C, t)
            for name, c in state.tracers.items()
        }
        return _replace(state, u=u, v=v, w=w, tracers=tracers)

    # ---------------------------------------------------------------------
    # Tendencies (reference nonhydrostatic_tendency_kernel_functions.jl)
    # ---------------------------------------------------------------------
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

    def compute_tendencies(self, state):
        g = self.grid
        u, v, w = state.u, state.v, state.w
        tracers = state.tracers
        time = state.clock.time
        fields = state.fields()

        diffusivities = closures_mod.compute_diffusivities(
            self.closure, g, u, v, w, tracers, self.buoyancy,
            top_fluxes=self._top_flux_values(time))

        if self.background_fields:
            # mean-flow decomposition: advect (q + q_bg) by (U + U_bg),
            # minus the background self-advection (assumed balanced;
            # reference background_fields.jl semantics). Backgrounds may
            # be time-dependent f(x, y, z, t) (reference
            # background_fields.jl:52-58) — evaluated at the traced clock
            # time, so oscillating mean flows trace into the step.
            bg = {}
            for name, fn in self.background_fields.items():
                bg[name] = self._eval_background(
                    fn, self.locations[name], time)
            ub = bg.get("u", jnp.zeros_like(u))
            vb = bg.get("v", jnp.zeros_like(v))
            wb = bg.get("w", jnp.zeros_like(w))
            ut, vt, wt = u + ub, v + vb, w + wb
            Gu = -(div_vu(g, self.advection, ut, vt, wt)
                   - div_vu(g, self.advection, ub, vb, wb))
            Gv = -(div_vv(g, self.advection, ut, vt, wt)
                   - div_vv(g, self.advection, ub, vb, wb))
            Gw = -(div_vw(g, self.advection, ut, vt, wt)
                   - div_vw(g, self.advection, ub, vb, wb))
        else:
            bg = {}
            ut, vt, wt = u, v, w
            Gu = -div_vu(g, self.advection, u, v, w)
            Gv = -div_vv(g, self.advection, u, v, w)
            Gw = -div_vw(g, self.advection, u, v, w)

        if self.stokes_drift is not None:
            Gu = Gu + self.stokes_drift.x_tendency(g, u, v, w, time)
            Gv = Gv + self.stokes_drift.y_tendency(g, u, v, w, time)
            Gw = Gw + self.stokes_drift.z_tendency(g, u, v, w, time)

        if self.coriolis is not None:
            Gu = Gu - self.coriolis.x_f_cross_U(g, u, v, w)
            Gv = Gv - self.coriolis.y_f_cross_U(g, u, v, w)
            Gw = Gw - self.coriolis.z_f_cross_U(g, u, v, w)

        if self.buoyancy is not None:
            for contrib, G in (("x_contribution", "Gu"),
                               ("y_contribution", "Gv"),
                               ("z_contribution", "Gw")):
                term = getattr(self.buoyancy, contrib)(g, tracers)
                if term is not None:
                    if G == "Gu":
                        Gu = Gu + term
                    elif G == "Gv":
                        Gv = Gv + term
                    else:
                        Gw = Gw + term

        du, dv, dw = closures_mod.momentum_flux_divergences(
            self.closure, g, u, v, w, tracers, diffusivities,
            include_implicit=False)
        Gu = Gu + du
        Gv = Gv + dv
        Gw = Gw + dw

        for name, fn, loc in (("u", None, LOC_U), ("v", None, LOC_V),
                              ("w", None, LOC_W)):
            f = self.forcings[name]
            if f is not None:
                term = f(g, time, fields)
                if name == "u":
                    Gu = Gu + term
                elif name == "v":
                    Gv = Gv + term
                else:
                    Gw = Gw + term

        # boundary fluxes into tendencies (reference apply_flux_bcs!,
        # compute_nonhydrostatic_tendencies.jl:202-208)
        Gu = apply_flux_bcs(Gu, g, self.bcs["u"], LOC_U, time, fields)
        Gv = apply_flux_bcs(Gv, g, self.bcs["v"], LOC_V, time, fields)
        Gw = apply_flux_bcs(Gw, g, self.bcs["w"], LOC_W, time, fields)

        if self.immersed_bcs:
            from oceananigans_tpu.immersed import immersed_flux_divergence
            for name, vel, loc in (("u", u, LOC_U), ("v", v, LOC_V),
                                   ("w", w, LOC_W)):
                ib = self.immersed_bcs.get(name)
                if ib is None:
                    continue
                term = immersed_flux_divergence(g, ib, loc, vel,
                                                self._ib_kappa[name], time)
                if name == "u":
                    Gu = Gu + term
                elif name == "v":
                    Gv = Gv + term
                else:
                    Gw = Gw + term

        Gtracers = {}
        for name in self.tracer_names:
            c = tracers[name]
            # AdvectiveForcing velocities are summed into the advecting
            # flow for this tracer (reference with_advective_forcing)
            uta, vta, wta = ut, vt, wt
            for af in self.advective_forcings.get(name, ()):
                ua, va, wa = af.velocities(g)
                uta, vta, wta = uta + ua, vta + va, wta + wa
            # tracers are advected by the TOTAL velocity; a background
            # tracer contributes its advection by the perturbation flow
            # (total·total minus background·background)
            if name in bg:
                cb = bg[name]
                ub0 = bg.get("u", jnp.zeros_like(u))
                vb0 = bg.get("v", jnp.zeros_like(v))
                wb0 = bg.get("w", jnp.zeros_like(w))
                Gc = -(div_Uc(g, self.advection, uta, vta, wta, c + cb)
                       - div_Uc(g, self.advection, ub0, vb0, wb0, cb))
            else:
                Gc = -div_Uc(g, self.advection, uta, vta, wta, c)
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
                    Gc = Gc - div_Uc(g, self.advection, wu, wv, ww, c)
            f = self.forcings[name]
            if f is not None:
                Gc = Gc + f(g, time, fields)
            Gc = apply_flux_bcs(Gc, g, self.bcs[name], LOC_C, time, fields)
            ib = self.immersed_bcs.get(name)
            if ib is not None:
                from oceananigans_tpu.immersed import (
                    immersed_flux_divergence,
                )
                Gc = Gc + immersed_flux_divergence(
                    g, ib, LOC_C, c, self._ib_kappa[name], time)
            Gtracers[name] = Gc

        if self.biogeochemistry is not None:
            Gtracers = self.biogeochemistry.update_tendencies(
                g, Gtracers, time, fields)

        for hook in getattr(self, "tendency_callbacks", ()):
            G = {"u": Gu, "v": Gv, "w": Gw, **Gtracers}
            G = hook(g, state, G)
            Gu, Gv, Gw = G["u"], G["v"], G["w"]
            Gtracers = {n: G[n] for n in Gtracers}

        return Gu, Gv, Gw, Gtracers, diffusivities

    # ---------------------------------------------------------------------
    # Pressure projection (reference solve_for_pressure.jl +
    # pressure_correction.jl)
    # ---------------------------------------------------------------------
    def _pressure_correct(self, state, dt):
        g = self.grid
        div = divergence_ccc(g, state.u, state.v, state.w)
        rhs = g.interior(div) / dt
        if getattr(self.pressure_solver, "wants_grid", False):
            # distribution-aware solvers need the CURRENT (per-shard)
            # grid, not the one captured at construction
            phi_int = self.pressure_solver.solve(rhs, g)
        else:
            phi_int = self.pressure_solver.solve(rhs)
        p = new_field(g, phi_int.dtype)
        sx, sy, sz = g.interior_slices
        p = p.at[sx, sy, sz].set(phi_int)
        p = self._fill_field(p, self.pressure_bcs, LOC_C,
                             state.clock.time)
        gx = ddx_f(g, p, Center)
        gy = ddy_f(g, p, Center)
        gz = ddz_f(g, p)
        from oceananigans_tpu.immersed import ImmersedBoundaryGrid
        if isinstance(g, ImmersedBoundaryGrid):
            # the masked Poisson operator has zero flux through solid
            # faces; the correction must not update them either or the
            # discrete projection identity div(u − Δt∇p) = 0 breaks
            gx = jnp.where(g.solid_u, 0.0, gx)
            gy = jnp.where(g.solid_v, 0.0, gy)
            gz = jnp.where(g.solid_w, 0.0, gz)
        u = state.u - dt * gx
        v = state.v - dt * gy
        w = state.w - dt * gz
        return _replace(state, u=u, v=v, w=w, pressure=p)

    def _implicit_diffusion(self, state, diffusivities, dt):
        if not closures_mod.closure_is_vertically_implicit(self.closure):
            return state
        u, v, tracers = closures_mod.implicit_vertical_diffusion_step(
            self.grid, self.closure, diffusivities, dt,
            u=state.u, v=state.v, tracers=state.tracers)
        return _replace(state, u=u, v=v, tracers=tracers)

    # ---------------------------------------------------------------------
    # Steps
    # ---------------------------------------------------------------------
    def step(self, state, dt, assume_filled=False):
        """One full time step (pure; jit me).

        ``assume_filled=True`` skips the leading halo fill: every step
        ENDS with a halo fill, so inside a multi-step window the leading
        fill of steps 2..n re-fills already-consistent halos (the clock
        time it would fill at is the same time the previous step's
        trailing fill used). ``Simulation`` fills once at window entry
        and passes ``assume_filled=True`` to the loop body."""
        dt = jnp.asarray(dt, state.u.dtype)
        if self.timestepper == "RungeKutta3":
            state = self.rk3_step(state, dt, assume_filled=assume_filled)
        elif self.timestepper == "QuasiAdamsBashforth2":
            state = self.ab2_step(state, dt, assume_filled=assume_filled)
        else:
            raise ValueError(f"unknown timestepper {self.timestepper!r}")
        # Lagrangian particles advect at the end of the step (reference
        # quasi_adams_bashforth_2.jl:109)
        if self.particles is not None and state.particles is not None:
            parts = self.particles.step(
                self.grid, state.particles, state.u, state.v, state.w,
                state.fields(), dt)
            state = _replace(state, particles=parts)
        return state

    def rk3_step(self, state, dt, assume_filled=False):
        """3-stage Wray RK3 with per-stage projection (reference
        ``runge_kutta_3.jl:56-132``)."""
        Gu_prev, Gv_prev, Gw_prev = state.Gu, state.Gv, state.Gw
        Gt_prev = state.Gtracers
        t0 = state.clock.time
        stage_frac = 0.0
        for stage, (gamma, zeta) in enumerate(RK3_STAGES):
            # evaluate time-dependent forcing/BCs at the stage time
            stage_clock = dataclasses.replace(
                state.clock, time=t0 + stage_frac * dt)
            state = _replace(state, clock=stage_clock)
            if stage > 0 or not assume_filled:
                state = self.fill_state_halos(state)
            Gu, Gv, Gw, Gt, diffusivities = self.compute_tendencies(state)
            stage_frac += gamma + zeta
            stage_dt = dt * (gamma + zeta)
            u = state.u + dt * (gamma * Gu + zeta * Gu_prev)
            v = state.v + dt * (gamma * Gv + zeta * Gv_prev)
            w = state.w + dt * (gamma * Gw + zeta * Gw_prev)
            tracers = {
                name: state.tracers[name]
                + dt * (gamma * Gt[name] + zeta * Gt_prev[name])
                for name in self.tracer_names
            }
            state = _replace(state, u=u, v=v, w=w, tracers=tracers)
            state = self._implicit_diffusion(state, diffusivities, stage_dt)
            state = self._fill_before_projection(state)
            state = self._pressure_correct(state, stage_dt)
            Gu_prev, Gv_prev, Gw_prev, Gt_prev = Gu, Gv, Gw, Gt
        state = _replace(state, Gu=Gu_prev, Gv=Gv_prev, Gw=Gw_prev,
                         Gtracers=Gt_prev,
                         clock=tick(dataclasses.replace(state.clock,
                                                        time=t0), dt))
        return self.fill_state_halos(state)

    def ab2_step(self, state, dt, chi=0.1, assume_filled=False):
        """Quasi-AB2 with branch-free Euler first step (reference
        ``quasi_adams_bashforth_2.jl:74-175``)."""
        if not assume_filled:
            state = self.fill_state_halos(state)
        c_now, c_prev = ab2_coefficients(state.clock.iteration, chi)
        Gu, Gv, Gw, Gt, diffusivities = self.compute_tendencies(state)
        u = state.u + dt * (c_now * Gu + c_prev * state.Gu)
        v = state.v + dt * (c_now * Gv + c_prev * state.Gv)
        w = state.w + dt * (c_now * Gw + c_prev * state.Gw)
        tracers = {
            name: state.tracers[name]
            + dt * (c_now * Gt[name] + c_prev * state.Gtracers[name])
            for name in self.tracer_names
        }
        state = _replace(state, u=u, v=v, w=w, tracers=tracers,
                         Gu=Gu, Gv=Gv, Gw=Gw, Gtracers=Gt)
        state = self._implicit_diffusion(state, diffusivities, dt)
        state = self._fill_before_projection(state)
        state = self._pressure_correct(state, dt)
        state = _replace(state, clock=tick(state.clock, dt))
        return self.fill_state_halos(state)

    # ---------------------------------------------------------------------
    def cfl_timescale(self, state):
        return cell_advection_timescale(self.grid, state.u, state.v, state.w)

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
        return (f"NonhydrostaticModel(grid={self.grid!r}, "
                f"advection={self.advection!r}, "
                f"tracers={self.tracer_names}, "
                f"timestepper={self.timestepper!r})")


class _ModelAux:
    """Hashable-by-identity aux wrapper for the model's static config."""

    def __init__(self, model):
        self.d = {k: v for k, v in model.__dict__.items() if k != "grid"}

    def __eq__(self, other):
        return isinstance(other, _ModelAux) and _aux_key(self.d) == _aux_key(
            other.d)

    def __hash__(self):
        return hash(_aux_key(self.d))


def _aux_key(d):
    return (repr(sorted(d.keys())),
            tuple(id(v) if not _hashable(v) else v
                  for _, v in sorted(d.items(), key=lambda kv: kv[0])))


def _hashable(v):
    try:
        hash(v)
        return True
    except TypeError:
        return False


jax.tree_util.register_pytree_node(
    NonhydrostaticModel,
    lambda m: m.tree_flatten(),
    NonhydrostaticModel.tree_unflatten,
)
