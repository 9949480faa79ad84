"""ShallowWaterModel: rotating shallow water equations.

Reference: ``src/Models/ShallowWaterModels/`` (SURVEY.md §2.14) — struct
``shallow_water_model.jl:39-55``, ``ConservativeFormulation`` (uh, vh, h) vs
``VectorInvariantFormulation`` (u, v, h) (``:57-59``), RK3-only stepping
(``rk3_substep_shallow_water_model.jl``), tendencies
(``solution_and_tracer_tendencies.jl``), bathymetry support.

Conservative form:
    ∂t(uh) = −∇·(𝐮 uh) + f vh − g h ∂x(h + b) + F
    ∂t(vh) = −∇·(𝐮 vh) − f uh − g h ∂y(h + b) + F
    ∂t h   = −∇·(uh, vh)
with transport velocities u = uh/h, and bathymetry height b(x, y)
(bottom at z = −depth, b = −depth; the surface is η = h + b).

Tracers are advected as concentrations: ∂t c = −(1/h) ∇·(𝐔 c) + ...
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp

from oceananigans_tpu.advection import (
    Centered, div_Uc, _face_value, _scheme_for,
)
from oceananigans_tpu.boundary_conditions import (
    apply_flux_bcs, fill_halo_regions, regularize_field_boundary_conditions,
)
from oceananigans_tpu.buoyancy import g_Earth
from oceananigans_tpu.fields import LOC_C, LOC_U, LOC_V, new_field, set_field
from oceananigans_tpu.forcings import materialize_forcing
from oceananigans_tpu.grids.base import Center, Face, Flat
from oceananigans_tpu.models.nonhydrostatic import _ModelAux
from oceananigans_tpu.ops.operators import (
    dx_c, dx_f, dy_c, dy_f, ix_c, ix_f, iy_c, iy_f, vorticity_z_ff,
)
from oceananigans_tpu.timesteppers import Clock, RK3_STAGES, tick

__all__ = ["ShallowWaterModel", "ShallowWaterState",
           "ConservativeFormulation", "VectorInvariantFormulation"]

X, Y, Z = 0, 1, 2

ConservativeFormulation = "conservative"
VectorInvariantFormulation = "vector_invariant"


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShallowWaterState:
    """Conservative: (uh, vh, h); vector-invariant: (u, v, h) stored in the
    same slots."""
    uh: jnp.ndarray
    vh: jnp.ndarray
    h: jnp.ndarray
    tracers: Dict[str, jnp.ndarray]
    clock: Clock
    Guh: jnp.ndarray
    Gvh: jnp.ndarray
    Gh: jnp.ndarray
    Gtracers: Dict[str, jnp.ndarray]

    def fields(self):
        return {"uh": self.uh, "vh": self.vh, "h": self.h, **self.tracers}


def _replace(state, **kw):
    return dataclasses.replace(state, **kw)


class ShallowWaterModel:
    """Reference keyword surface (``shallow_water_model.jl:86``): grid,
    gravitational_acceleration, advection, coriolis, bathymetry, tracers,
    formulation."""

    def __init__(self, grid, gravitational_acceleration=g_Earth,
                 momentum_advection=None, tracer_advection=None,
                 coriolis=None, bathymetry=None, tracers=(),
                 formulation=ConservativeFormulation,
                 forcing=None, boundary_conditions=None):
        if grid.topology[2] != Flat:
            raise ValueError("ShallowWaterModel needs a Flat z topology "
                             "(2-D grid)")
        if momentum_advection is None:
            momentum_advection = Centered(2)
        if tracer_advection is None:
            tracer_advection = Centered(2)
        if isinstance(tracers, str):
            tracers = (tracers,)
        if formulation not in (ConservativeFormulation,
                               VectorInvariantFormulation):
            raise ValueError(f"unknown formulation {formulation!r}")

        self.grid = grid
        self.g = float(gravitational_acceleration)
        self.momentum_advection = momentum_advection
        self.tracer_advection = tracer_advection
        self.coriolis = coriolis
        self.formulation = formulation
        self.tracer_names = tuple(tracers)

        # bathymetry height b(x, y) at centers (bottom elevation; ≤ 0 for
        # submerged topography)
        if bathymetry is None:
            self.bathymetry = 0.0
        elif callable(bathymetry):
            x, y = grid.xC, grid.yC
            self.bathymetry = jnp.broadcast_to(
                jnp.asarray(bathymetry(x, y), grid.xC.dtype),
                (grid.shape[0], grid.shape[1], 1))
        else:
            self.bathymetry = bathymetry

        boundary_conditions = dict(boundary_conditions or {})
        self.locations = {"uh": LOC_U, "vh": LOC_V, "h": LOC_C,
                          **{t: LOC_C for t in self.tracer_names}}
        self.bcs = {
            name: regularize_field_boundary_conditions(
                boundary_conditions.get(name), grid, loc)
            for name, loc in self.locations.items()
        }
        forcing = dict(forcing or {})
        self.forcings = {
            name: materialize_forcing(forcing.get(name), name,
                                      self.locations[name])
            for name in self.locations
        }

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
        vel = ("uh", "vh") if self.formulation == ConservativeFormulation \
            else ("u", "v")
        allowed = set(vel) | {"h"} | set(self.tracer_names)
        unknown = set(field_values) - allowed
        if unknown:
            raise ValueError(
                f"unknown initial_state fields {sorted(unknown)}; "
                f"this formulation takes {sorted(allowed)}")

        def mk(name, loc, default=0.0):
            if name in field_values:
                return set_field(g, field_values[name], loc=loc, dtype=dtype)
            return set_field(g, default, loc=loc, dtype=dtype)

        uh = mk("uh" if self.formulation == ConservativeFormulation else "u",
                LOC_U)
        vh = mk("vh" if self.formulation == ConservativeFormulation else "v",
                LOC_V)
        h = mk("h", LOC_C, default=1.0)
        tracers = {t: mk(t, LOC_C) for t in self.tracer_names}
        state = ShallowWaterState(
            uh=uh, vh=vh, h=h, tracers=tracers,
            clock=Clock.start(time, dtype),
            Guh=new_field(g, dtype), Gvh=new_field(g, dtype),
            Gh=new_field(g, dtype),
            Gtracers={t: new_field(g, dtype) for t in self.tracer_names},
        )
        return self.fill_state_halos(state)

    def fill_state_halos(self, state):
        g = self.grid
        t = state.clock.time
        dtl = state.clock.last_dt
        uh = fill_halo_regions(state.uh, g, self.bcs["uh"], LOC_U, t,
                               dt=dtl)
        vh = fill_halo_regions(state.vh, g, self.bcs["vh"], LOC_V, t,
                               dt=dtl)
        h = fill_halo_regions(state.h, g, self.bcs["h"], LOC_C, t)
        tracers = {
            name: fill_halo_regions(c, g, self.bcs[name], LOC_C, t)
            for name, c in state.tracers.items()
        }
        return _replace(state, uh=uh, vh=vh, h=h, tracers=tracers)

    # ------------------------------------------------------------------
    def _transport_and_velocity(self, state):
        """(U, V, u, v): depth-integrated transports at faces and
        velocities, for either formulation."""
        h_fc = ix_f(state.h)
        h_cf = iy_f(state.h)
        if self.formulation == ConservativeFormulation:
            U, V = state.uh, state.vh
            u = U / h_fc
            v = V / h_cf
        else:
            u, v = state.uh, state.vh
            U = u * h_fc
            V = v * h_cf
        return U, V, u, v

    def _momentum_flux_div_u(self, grid, scheme, u, v, Q):
        """∇·(𝐮 Q) for an x-face-located conserved quantity Q (= uh)."""
        sx = _scheme_for(scheme, X)
        sy = _scheme_for(scheme, Y)
        Uadv = ix_c(grid.Ax(Face, Center, Center) * u)
        fxx = Uadv * _face_value(sx, Uadv, Q, X, 1)
        Vadv = ix_f(grid.Ay(Center, Face, Center) * v)
        fxy = Vadv * _face_value(sy, Vadv, Q, Y, 0)
        return (dx_f(fxx) + dy_c(fxy)) / grid.V(Face, Center, Center)

    def _momentum_flux_div_v(self, grid, scheme, u, v, Q):
        sx = _scheme_for(scheme, X)
        sy = _scheme_for(scheme, Y)
        Uadv = iy_f(grid.Ax(Face, Center, Center) * u)
        fyx = Uadv * _face_value(sx, Uadv, Q, X, 0)
        Vadv = iy_c(grid.Ay(Center, Face, Center) * v)
        fyy = Vadv * _face_value(sy, Vadv, Q, Y, 1)
        return (dx_c(fyx) + dy_f(fyy)) / grid.V(Center, Face, Center)

    def compute_tendencies(self, state):
        g = self.grid
        U, V, u, v = self._transport_and_velocity(state)
        h = state.h
        time = state.clock.time
        fields = state.fields()
        eta = h + self.bathymetry

        if self.formulation == ConservativeFormulation:
            Guh = -self._momentum_flux_div_u(g, self.momentum_advection,
                                             u, v, state.uh)
            Gvh = -self._momentum_flux_div_v(g, self.momentum_advection,
                                             u, v, state.vh)
            # −g h ∂x(h+b) at (f,c)
            Guh = Guh - self.g * ix_f(h) * dx_f(eta) / g.dx(Face, Center)
            Gvh = Gvh - self.g * iy_f(h) * dy_f(eta) / g.dy(Face, Center)
            if self.coriolis is not None:
                # f × (uh, vh): use transports for momentum conservation
                Guh = Guh - self.coriolis.x_f_cross_U(g, state.uh, state.vh,
                                                      jnp.zeros_like(h))
                Gvh = Gvh - self.coriolis.y_f_cross_U(g, state.uh, state.vh,
                                                      jnp.zeros_like(h))
        else:
            # vector-invariant: ∂t u = ζ v̂ − ∂x(K + g(h+b)) with the
            # length-weighted v̂ and scheme dispatch shared with the
            # hydrostatic model (reference: the SW model reuses
            # ``horizontal_advection_U`` + ``bernoulli_head_U`` from
            # ``vector_invariant_advection.jl``)
            from oceananigans_tpu.models.hydrostatic import (
                VectorInvariant,
            )
            vi = self.momentum_advection if isinstance(
                self.momentum_advection, VectorInvariant) \
                else VectorInvariant()
            zeta = vorticity_z_ff(g, u, v)
            K = 0.5 * (ix_c(u * u) + iy_c(v * v))
            phi = K + self.g * eta
            Guh = vi._zeta_v(g, zeta, u, v) \
                - dx_f(phi) / g.dx(Face, Center)
            Gvh = -vi._zeta_u(g, zeta, u, v) \
                - dy_f(phi) / g.dy(Face, Center)
            if self.coriolis is not None:
                Guh = Guh - self.coriolis.x_f_cross_U(g, u, v,
                                                      jnp.zeros_like(h))
                Gvh = Gvh - self.coriolis.y_f_cross_U(g, u, v,
                                                      jnp.zeros_like(h))

        # mass: ∂t h = −∇·(U, V)
        Gh = -(dx_c(g.dy(Center, Face) * U)
               + dy_c(g.dx(Center, Face) * V)) / g.Az(Center, Center)

        for name, G in (("uh", Guh), ("vh", Gvh), ("h", Gh)):
            f = self.forcings[name]
            if f is not None:
                if name == "uh":
                    Guh = Guh + f(g, time, fields)
                elif name == "vh":
                    Gvh = Gvh + f(g, time, fields)
                else:
                    Gh = Gh + f(g, time, fields)

        Guh = apply_flux_bcs(Guh, g, self.bcs["uh"], LOC_U, time, fields)
        Gvh = apply_flux_bcs(Gvh, g, self.bcs["vh"], LOC_V, time, fields)

        Gtracers = {}
        for name in self.tracer_names:
            c = state.tracers[name]
            Gc = -div_Uc(g, self.tracer_advection, u, v,
                         jnp.zeros_like(c), c)
            f = self.forcings[name]
            if f is not None:
                Gc = Gc + f(g, time, fields)
            Gtracers[name] = Gc

        return Guh, Gvh, Gh, Gtracers

    # ------------------------------------------------------------------
    def step(self, state, dt):
        """RK3 (the reference's only SW stepper,
        ``rk3_substep_shallow_water_model.jl``)."""
        dt = jnp.asarray(dt, state.h.dtype)
        G_prev = (state.Guh, state.Gvh, state.Gh, state.Gtracers)
        for gamma, zeta in RK3_STAGES:
            state = self.fill_state_halos(state)
            Guh, Gvh, Gh, Gt = self.compute_tendencies(state)
            uh = state.uh + dt * (gamma * Guh + zeta * G_prev[0])
            vh = state.vh + dt * (gamma * Gvh + zeta * G_prev[1])
            h = state.h + dt * (gamma * Gh + zeta * G_prev[2])
            tracers = {
                name: state.tracers[name]
                + dt * (gamma * Gt[name] + zeta * G_prev[3][name])
                for name in self.tracer_names
            }
            state = _replace(state, uh=uh, vh=vh, h=h, tracers=tracers)
            G_prev = (Guh, Gvh, Gh, Gt)
        state = _replace(state, Guh=G_prev[0], Gvh=G_prev[1], Gh=G_prev[2],
                         Gtracers=G_prev[3], clock=tick(state.clock, dt))
        return self.fill_state_halos(state)

    def cfl_timescale(self, state):
        from oceananigans_tpu.advection import cell_advection_timescale
        _, _, u, v = self._transport_and_velocity(state)
        return cell_advection_timescale(self.grid, u, v,
                                        jnp.zeros_like(u))

    def __repr__(self):
        return (f"ShallowWaterModel(grid={self.grid!r}, g={self.g:g}, "
                f"formulation={self.formulation!r})")


jax.tree_util.register_pytree_node(
    ShallowWaterModel,
    lambda m: m.tree_flatten(),
    ShallowWaterModel.tree_unflatten,
)
