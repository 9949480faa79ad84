"""Time stepping schemes: coefficients + clock.

Reference layer: ``src/TimeSteppers/`` (SURVEY.md §2.10) —
``QuasiAdamsBashforth2TimeStepper`` (``quasi_adams_bashforth_2.jl:4-9``),
``RungeKutta3TimeStepper`` (``runge_kutta_3.jl:10-19``), ``Clock``
(``clock.jl:16``).

Design: there is no stepper object mutating fields; each model
exposes a pure ``step(state, dt) -> state`` assembled from these
coefficient tables. The AB2 Euler first step is branch-free — coefficients
are selected with ``jnp.where`` on the iteration counter, the jit-friendly
equivalent of the reference Reactant extension hoisting the Euler branch to
a static flag (``ext/OceananigansReactantExt/TimeSteppers.jl:82-90``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

__all__ = ["Clock", "RK3_STAGES", "ab2_coefficients", "tick"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Clock:
    """Traced time/iteration/stage (reference ``clock.jl:16``).

    DateTime-capable (reference ``clock.jl`` supports ``time::DateTime``):
    the form here keeps the traced device scalar in SECONDS and
    carries the calendar origin as static pytree metadata (``epoch``, a
    ``datetime.datetime`` or None) — the compiled step never touches
    calendar arithmetic. Construct with ``Clock.start(datetime(...))``
    and read ``clock.date``."""
    time: jnp.ndarray
    iteration: jnp.ndarray
    last_dt: jnp.ndarray
    epoch: object = dataclasses.field(default=None,
                                      metadata=dict(static=True))

    @classmethod
    def start(cls, time=0.0, dtype=jnp.float64, epoch=None):
        import datetime as _dt
        if isinstance(time, _dt.datetime):
            epoch, time = time, 0.0
        try:
            t = jnp.asarray(time, dtype)
        except TypeError:
            t = jnp.asarray(time, jnp.float32)
        return cls(time=t, iteration=jnp.asarray(0, jnp.int32),
                   last_dt=jnp.zeros_like(t), epoch=epoch)

    @property
    def date(self):
        """Calendar time ``epoch + time`` seconds (host-side; None when
        the clock has no epoch). Reference ``float_or_date_time``."""
        if self.epoch is None:
            return None
        import datetime as _dt
        return self.epoch + _dt.timedelta(seconds=float(self.time))


def tick(clock: Clock, dt) -> Clock:
    return Clock(time=clock.time + dt,
                 iteration=clock.iteration + 1,
                 last_dt=jnp.asarray(dt, clock.time.dtype)
                 + jnp.zeros_like(clock.last_dt),
                 epoch=clock.epoch)


#: low-storage Wray RK3 (γⁿ, ζⁿ) per stage (reference
#: ``runge_kutta_3.jl:10-19``). Stage increment: Ψ += Δt (γ Gⁿ + ζ G⁻);
#: the pressure correction of each stage uses the substep Δt·(γ+ζ).
RK3_STAGES = ((8.0 / 15.0, 0.0),
              (5.0 / 12.0, -17.0 / 60.0),
              (3.0 / 4.0, -5.0 / 12.0))


def ab2_coefficients(iteration, chi=0.1):
    """Branch-free quasi-AB2 coefficients: Euler on iteration 0, else
    ``(3/2+χ, −(1/2+χ))`` (reference ``quasi_adams_bashforth_2.jl:74-115``).
    """
    euler = iteration == 0
    c_now = jnp.where(euler, 1.0, 1.5 + chi)
    c_prev = jnp.where(euler, 0.0, -(0.5 + chi))
    return c_now, c_prev
