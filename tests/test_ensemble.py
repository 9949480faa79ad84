"""Ensemble (vmap) mode."""

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu import (
    Bounded, Flat, RectilinearGrid, VerticalScalarDiffusivity,
    VerticallyImplicitTimeDiscretization,
)
from oceananigans_tpu.ensemble import EnsembleModel
from oceananigans_tpu.models import NonhydrostaticModel


def test_ensemble_columns():
    """64 independent diffusion columns advance in one batched dispatch
    and match per-member serial runs."""
    grid = RectilinearGrid(size=(16,), z=(0.0, np.pi),
                           topology=(Flat, Flat, Bounded))
    kappa = 0.1
    model = NonhydrostaticModel(
        grid=grid, advection=None, tracers=("c",),
        closure=VerticalScalarDiffusivity(
            kappa=kappa,
            time_discretization=VerticallyImplicitTimeDiscretization))
    n = 8
    amps = np.linspace(0.5, 2.0, n)
    ens = EnsembleModel(model, n=n)
    states = ens.initial_states(
        c=lambda m, x, y, z: amps[m] * jnp.cos(z))
    dt = 1e-3
    for _ in range(20):
        states = ens.step(states, dt)
    # member 3 must equal the serial run of the same column
    serial = model.initial_state(c=lambda x, y, z: amps[3] * jnp.cos(z))
    step = jax.jit(lambda s: model.step(s, dt))
    for _ in range(20):
        serial = step(serial)
    member = ens.member(states, 3)
    np.testing.assert_allclose(np.asarray(member.tracers["c"]),
                               np.asarray(serial.tracers["c"]),
                               atol=1e-13)
