"""Ensembles of column models via vmap — the data-parallel axis.

Reference: ``src/Models/HydrostaticFreeSurfaceModels/
slice_ensemble_model_mode.jl`` / ``single_column_model_mode.jl`` run
ensembles of 1-D column models batched over the (i, j) plane (SURVEY.md
§2.11, strategy 6). The expression here is ``jax.vmap`` over a
leading ensemble axis of the state pytree: one jitted, fully-batched step
advances every ensemble member — XLA vectorizes the column physics
(CATKE, convective adjustment, implicit diffusion) across members, and an
extra mesh axis shards members across devices for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["EnsembleModel"]


class EnsembleModel:
    """Batch a column (or any) model over an ensemble axis.

    Usage::

        column = NonhydrostaticModel(grid=column_grid, ...)
        ens = EnsembleModel(column, n=64)
        states = ens.initial_states(
            c=lambda member, x, y, z: member_profiles[member])
        states = ens.step(states, dt)      # one dispatch, 64 members
    """

    def __init__(self, model, n: int):
        self.model = model
        self.n = int(n)
        self._step = jax.jit(jax.vmap(model.step, in_axes=(0, None)))

    def initial_states(self, **field_values):
        """Stack per-member initial states. Values may be callables
        ``f(member_index, x, y, z)`` or arrays with a leading (n,) axis."""
        states = []
        for m in range(self.n):
            kw = {}
            for name, val in field_values.items():
                if callable(val):
                    kw[name] = (lambda x, y, z, val=val, m=m:
                                val(m, x, y, z))
                else:
                    kw[name] = val[m]
            states.append(self.model.initial_state(**kw))
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)

    def step(self, states, dt):
        return self._step(states, dt)

    def member(self, states, m: int):
        """Extract one member's state."""
        return jax.tree_util.tree_map(lambda x: x[m], states)
