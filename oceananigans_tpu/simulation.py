"""Simulation driver: the run loop, callbacks, adaptive Δt, NaN guard.

Reference layer: ``src/Simulations/`` (SURVEY.md §2.15) — ``Simulation``
(``simulation.jl:11-26``), ``run!`` (``run.jl:92-113``), Δt alignment
(``run.jl:24-57``), ``Callback`` (``callback.jl:7``), ``TimeStepWizard``
(``time_step_wizard.jl:5-14``), ``NaNChecker``
(``src/Models/nan_checker.jl:3-31``).

Design: the schedule machinery stays outside the compiled region
(the Reactant lesson, SURVEY.md §3.5); between actuation times the driver
advances several steps inside ONE jitted ``lax.fori_loop`` dispatch, so the
host loop costs one dispatch per output window, not per step.
"""

from __future__ import annotations

import math
import time as _time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu.utils.schedules import (
    IterationInterval, TimeInterval,
)
from oceananigans_tpu.utils.pretty import prettytime

__all__ = ["Simulation", "Callback", "TimeStepWizard", "add_callback",
           "conjure_time_step_wizard", "iteration"]


# callback callsites (reference src/Oceananigans.jl:186-188):
#   TimeStepCallsite   — after a completed time step (host-side)
#   UpdateStateCallsite — right after the state update / halo fill,
#                         before the time-step callbacks and writers
#                         (host-side; also fired once at initialize)
#   TendencyCallsite   — inside the compiled step: the callback is a PURE
#                        function (grid, state, {name: G}) -> {name: G}
#                        traced into compute_tendencies (the functional
#                        analog of mutating model.timestepper.Gⁿ; its
#                        schedule is ignored — it runs every step)
TimeStepCallsite = "time_step"
TendencyCallsite = "tendency"
UpdateStateCallsite = "update_state"


class Callback:
    """func(simulation) on a schedule (reference ``callback.jl:7``);
    ``callsite`` is one of ``TimeStepCallsite`` (default),
    ``UpdateStateCallsite``, or ``TendencyCallsite`` (see the constants
    above for the semantics of each here)."""

    def __init__(self, func, schedule=None, callsite=TimeStepCallsite):
        self.func = func
        self.schedule = schedule or IterationInterval(1)
        self.callsite = callsite

    def __call__(self, sim):
        return self.func(sim)


class TimeStepWizard:
    """Adaptive Δt targeting an advective CFL (reference
    ``time_step_wizard.jl:5-14``)."""

    def __init__(self, cfl=0.2, diffusive_cfl=np.inf, max_change=1.1,
                 min_change=0.5, max_dt=np.inf, min_dt=0.0):
        self.cfl = cfl
        self.diffusive_cfl = diffusive_cfl
        self.max_change = max_change
        self.min_change = min_change
        self.max_dt = max_dt
        self.min_dt = min_dt

    def __call__(self, sim):
        tau = float(sim.model.cfl_timescale(sim.state))
        new_dt = self.cfl * tau
        if np.isfinite(self.diffusive_cfl):
            tau_d = float(sim.model.diffusion_timescale(sim.state))
            new_dt = min(new_dt, self.diffusive_cfl * tau_d)
        new_dt = min(new_dt, self.max_change * sim.dt)
        new_dt = max(new_dt, self.min_change * sim.dt)
        sim.dt = float(np.clip(new_dt, self.min_dt, self.max_dt))


class NaNChecker:
    """Halts the run when a velocity field goes non-finite (reference
    ``nan_checker.jl:3-31``; wired as a default IterationInterval(100)
    callback like the reference Simulation constructor)."""

    def __init__(self, fields=("u",)):
        self.fields = fields

    def __call__(self, sim):
        state_fields = sim.state.fields()
        names = [n for n in self.fields if n in state_fields]
        if not names:
            # state without the configured names (e.g. a shallow-water
            # model's (uh, vh, h)): guard the first prognostic field
            names = [next(iter(state_fields))]
        for name in names:
            arr = state_fields[name]
            if not bool(jnp.all(jnp.isfinite(arr))):
                sim.running = False
                sim.stop_reason = f"NaN found in field {name!r}"
                raise RuntimeError(
                    f"time step {int(sim.state.clock.iteration)}: "
                    f"NaN found in {name!r}; aborting simulation")


class Simulation:
    """Drives ``model.step`` with schedules, callbacks, and writers.

    Usage mirrors the reference (``simulation.jl``)::

        sim = Simulation(model, state, dt=0.01, stop_time=10.0)
        sim.callbacks["progress"] = Callback(print_progress,
                                             IterationInterval(10))
        sim.output_writers["fields"] = HDF5Writer(...)
        sim.run()

    ``sim.state`` holds the current state pytree (replaced, never mutated).
    """

    def __init__(self, model, state=None, dt=None, stop_time=None,
                 stop_iteration=None, wall_time_limit=None):
        if dt is None:
            raise ValueError("Simulation needs dt=")
        self.model = model
        self.state = state if state is not None else model.initial_state()
        self.dt = float(dt)
        self.stop_time = stop_time
        self.stop_iteration = stop_iteration
        self.wall_time_limit = wall_time_limit
        self.callbacks: Dict[str, Callback] = {
            "nan_checker": Callback(NaNChecker(), IterationInterval(100)),
        }
        self.output_writers: Dict[str, object] = {}
        self.running = True
        self.stop_reason = None
        self.run_wall_time = 0.0
        self.initialized = False

        self._step1 = jax.jit(model.step, static_argnums=())
        self._stepn_cache = {}

    # ------------------------------------------------------------------
    def _stepn(self, n):
        """Jitted n-step advance (one dispatch per window)."""
        if n not in self._stepn_cache:
            import inspect
            model = self.model
            # every step ends with a halo fill, so steps inside the
            # window skip their (redundant) leading fill; one defensive
            # fill at window entry covers host-side state mutations
            # between windows (callbacks, pickup)
            fastpath = "assume_filled" in inspect.signature(
                model.step).parameters

            @jax.jit
            def stepn(state, dt):
                if fastpath:
                    state = model.fill_state_halos(state)
                    return jax.lax.fori_loop(
                        0, n,
                        lambda i, s: model.step(s, dt, assume_filled=True),
                        state)
                return jax.lax.fori_loop(
                    0, n, lambda i, s: model.step(s, dt), state)

            self._stepn_cache[n] = stepn
        return self._stepn_cache[n]

    def _all_schedules(self):
        for cb in self.callbacks.values():
            yield cb.schedule
        for w in self.output_writers.values():
            yield w.schedule

    def _inside_averaging_window(self):
        from oceananigans_tpu.utils.schedules import AveragedTimeInterval
        for w in self.output_writers.values():
            if isinstance(w.schedule, AveragedTimeInterval):
                if w.schedule.averaging(self.state.clock):
                    return True
        return False

    def _aligned_steps(self):
        """(n_steps, dt): how many dt-steps until the next schedule
        actuation / stop time (reference aligned_time_step, run.jl:24-57),
        batched into one compiled dispatch. Time-based schedules bound the
        window by a TIME horizon (Δt shrinks to land exactly on it);
        iteration-based schedules bound it by a STEP-count horizon — e.g.
        the default IterationInterval(100) NaN checker allows 100-step
        windows (one host→device dispatch per 100 steps)."""
        clock = self.state.clock
        t = float(clock.time)
        horizon_t = math.inf      # model time until next time actuation
        horizon_n = math.inf      # steps until next iteration actuation
        if self.stop_time is not None:
            horizon_t = min(horizon_t, self.stop_time - t)
        for s in self._all_schedules():
            nt = s.next_actuation_time(clock)
            if nt is not None:
                horizon_t = min(horizon_t, nt - t)
                continue
            ni = s.next_actuation_iteration(clock)
            if ni is not None:
                horizon_n = min(horizon_n, ni - int(clock.iteration))
                continue
            # wall-time / unknown schedules: check every step
            horizon_n = 1
        if math.isfinite(horizon_t) and horizon_t > 0:
            n_t = max(1, int(math.ceil(horizon_t / self.dt - 1e-9)))
        else:
            n_t = 1 if horizon_t <= 0 else None
        if not math.isfinite(horizon_n):
            horizon_n = None
        if n_t is None and horizon_n is None:
            return 1, self.dt
        if horizon_n is not None and (n_t is None or horizon_n < n_t):
            # the iteration horizon binds: plain dt, no alignment needed
            return max(1, int(horizon_n)), self.dt
        n = n_t
        dt = min(self.dt, horizon_t / n)
        # align exactly onto the time horizon when within one window
        if n * self.dt > horizon_t - 1e-12:
            dt = horizon_t / n
        return n, dt

    # ------------------------------------------------------------------
    def _host_callbacks(self):
        """(update_state, time_step) host-side callbacks, in callsite
        order; TendencyCallsite callbacks are traced into the step, not
        fired from the host."""
        upd = [cb for cb in self.callbacks.values()
               if getattr(cb, "callsite", TimeStepCallsite)
               == UpdateStateCallsite]
        ts = [cb for cb in self.callbacks.values()
              if getattr(cb, "callsite", TimeStepCallsite)
              not in (UpdateStateCallsite, TendencyCallsite)]
        return upd, ts

    def _wire_tendency_callbacks(self):
        """Attach TendencyCallsite callbacks to the model as pure traced
        hooks (grid, state, {name: G}) -> {name: G} — the functional
        analog of the reference's Gⁿ-mutating callbacks."""
        funcs = tuple(cb.func for cb in self.callbacks.values()
                      if getattr(cb, "callsite", None) == TendencyCallsite)
        if funcs and funcs != getattr(self.model, "tendency_callbacks",
                                      ()):
            self.model.tendency_callbacks = funcs
            self._stepn_cache = {}

    def initialize(self):
        """Actuate everything once at iteration 0 (reference run.jl:203-252)."""
        self._wire_tendency_callbacks()
        upd, ts = self._host_callbacks()
        for cb in upd + ts:
            cb.schedule.initialize(self.state.clock)
            if cb.schedule.actuates(self.state.clock):
                cb(self)
        wsim = (self.model.writer_sim(self)
                if hasattr(self.model, "writer_sim") else self)
        from oceananigans_tpu.output import Checkpointer
        for w in self.output_writers.values():
            w.schedule.initialize(self.state.clock)
            # checkpoints serialize the RAW state pytree (restart must
            # restore the exact layout the step runs on — under the
            # distributed adapter that is the local-halos layout)
            w.write(self if isinstance(w, Checkpointer) else wsim)
        self.initialized = True

    def _should_stop(self):
        if self.stop_iteration is not None and (
                int(self.state.clock.iteration) >= self.stop_iteration):
            self.stop_reason = "stop_iteration reached"
            return True
        if self.stop_time is not None and (
                float(self.state.clock.time) >= self.stop_time - 1e-12):
            self.stop_reason = "stop_time reached"
            return True
        if self.wall_time_limit is not None and (
                self.run_wall_time > self.wall_time_limit):
            self.stop_reason = "wall_time_limit exceeded"
            return True
        return False

    def run(self, pickup=False):
        """The run loop (reference run.jl:92-113). ``pickup=True`` restores
        the latest checkpoint from the first Checkpointer among the output
        writers before running (reference run.jl:66-98); ``pickup`` may
        also be a checkpoint file path."""
        if pickup:
            from oceananigans_tpu.output import Checkpointer
            ckpt = next((w for w in self.output_writers.values()
                         if isinstance(w, Checkpointer)), None)
            if ckpt is None:
                raise ValueError("pickup requested but no Checkpointer "
                                 "among output_writers")
            path = pickup if isinstance(pickup, str) else None
            self.state = ckpt.restore(self.state, path=path)
        if not self.initialized:
            self.initialize()
        while self.running and not self._should_stop():
            t0 = _time.monotonic()
            n, dt = self._aligned_steps()
            if self._inside_averaging_window():
                n = 1   # per-step accumulation inside averaging windows
            if self.stop_iteration is not None:
                n = min(n, self.stop_iteration
                        - int(self.state.clock.iteration))
                n = max(n, 1)
            if n == 1:
                self.state = self._step1(self.state, dt)
            else:
                self.state = self._stepn(n)(self.state,
                                            jnp.asarray(dt))
            self.run_wall_time += _time.monotonic() - t0

            upd, ts = self._host_callbacks()
            for cb in upd + ts:
                if cb.schedule.actuates(self.state.clock):
                    cb(self)
            if self.output_writers:
                from oceananigans_tpu.output import WindowedTimeAverage
                from oceananigans_tpu.utils.schedules import (
                    AveragedTimeInterval,
                )
                # distributed adapters expose a writer view (global
                # layout + global grid, halos filled); converting is a
                # device pass, so build it lazily — only when some
                # writer actually actuates or accumulates this window
                wsim = None

                def get_wsim():
                    nonlocal wsim
                    if wsim is None:
                        wsim = (self.model.writer_sim(self)
                                if hasattr(self.model, "writer_sim")
                                else self)
                    return wsim

                from oceananigans_tpu.output import Checkpointer
                for w in self.output_writers.values():
                    # windowed time averages accumulate while inside
                    # their averaging window (windowed_time_average.jl)
                    if isinstance(w.schedule, AveragedTimeInterval) and \
                            w.schedule.averaging(self.state.clock):
                        for out in getattr(w, "outputs", {}).values():
                            if isinstance(out, WindowedTimeAverage):
                                v = get_wsim()
                                out.accumulate(v.model, v.state)
                    if w.schedule.actuates(self.state.clock):
                        # checkpoints serialize the RAW state (restart
                        # restores the layout the step runs on)
                        w.write(self if isinstance(w, Checkpointer)
                                else get_wsim())
        return self.state

    def __repr__(self):
        return (f"Simulation(t={prettytime(float(self.state.clock.time))}, "
                f"iteration={int(self.state.clock.iteration)}, "
                f"dt={self.dt:g})")


def add_callback(sim, func, schedule=None, name=None,
                 callsite=TimeStepCallsite):
    """Attach a callback (reference ``add_callback!(sim, func;
    schedule, name)``). ``func`` may be a plain function or a
    :class:`Callback`."""
    cb = func if isinstance(func, Callback) else Callback(func, schedule,
                                                          callsite)
    if name is None:
        name = getattr(func, "__name__", None) or f"callback{len(sim.callbacks)}"
        base, k = name, 1
        while name in sim.callbacks:
            name = f"{base}{k}"
            k += 1
    sim.callbacks[name] = cb
    return name


def conjure_time_step_wizard(sim, schedule=None, **wizard_kwargs):
    """Attach a :class:`TimeStepWizard` on a schedule (reference
    ``conjure_time_step_wizard!(sim, schedule; kwargs...)``, default
    every 5 iterations)."""
    schedule = schedule or IterationInterval(5)
    sim.callbacks["time_step_wizard"] = Callback(
        TimeStepWizard(**wizard_kwargs), schedule)


def iteration(sim):
    """Current iteration count (reference ``iteration(sim)``)."""
    return int(sim.state.clock.iteration)
