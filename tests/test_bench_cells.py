"""Every bench cell, built by ``bench.build`` (the constructor
``chip_smoke.py`` runs at full width on the GPU) at a tiny size, stepped
through ``Simulation.run`` and held to the smoke run's checks, in
float64 to the CPU tests' own bounds."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

TINY = {**{c: (8, 8, 8) for c in bench.NONHYDRO_CELLS},
        "hydro_vi": (16, 12, 4), "sw8192": (16, 16), "cs_global": (8, 4)}


def test_every_cell_has_a_tiny_size():
    assert set(TINY) == set(bench.FULL_SIZE)


@pytest.mark.parametrize("config", sorted(bench.FULL_SIZE))
def test_cell_steps_and_passes_smoke_checks(config):
    rec = chip_smoke.run_cell(config, TINY[config], steps=2,
                              dtype="float64")
    assert rec["ok"], rec["checks"]
    assert rec["steps"] == 4
    checks = rec["checks"]
    if config in bench.NONHYDRO_CELLS:
        assert checks["max_div_normalized"]["value"] < 1e-12
    if config == "cs_global":
        # the bounds tests/test_cubed_sphere_ocean.py pins in float64
        assert checks["volume_drift"]["value"] < 1e-12
        assert checks["salt_drift"]["value"] < 1e-9


@pytest.mark.parametrize("config", ["default", "hydro_vi", "sw8192",
                                    "cs_global"])
def test_npoints_and_full_sizes(config):
    size = bench.FULL_SIZE[config]
    n = bench.npoints(config)
    if config == "cs_global":
        assert n == 6 * 48 * 48 * 16
    else:
        assert n == int(np.prod(size))


def test_divergence_check_flags_unprojected_flow():
    """The smoke run's divergence check sees a field no projection has
    touched."""
    import dataclasses

    import jax.numpy as jnp
    model, state, _ = bench.build("default", (8, 8, 8), "float64")
    u = state.u + 0.01 * jnp.arange(state.u.size).reshape(state.u.shape)
    bad = dataclasses.replace(state, u=u)
    _, dn = chip_smoke.normalized_divergence(model, bad)
    assert dn > chip_smoke.DIVERGENCE_TOL
