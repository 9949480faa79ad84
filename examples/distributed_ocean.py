"""Distributed realistic-ocean demo: a wind-driven gyre over a seamount
on a LatitudeLongitudeGrid, stepped on the explicit-halo multi-chip path.

The whole hydrostatic step — split-explicit barotropic substepping
included — runs inside one ``shard_map`` over the device mesh, with two
``ppermute`` exchanges per distributed axis per field fill (bounded
collectives, independent of stencil order). The grid's
latitude-dependent metrics and bathymetry masks ride through
``shard_map`` as sharded leaves, so each shard's model sees its own
latitude band and bottom window.

Run on any number of devices (CPU demo):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python examples/distributed_ocean.py

On several GPUs, the same script scales over the real mesh.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax

# pin via the config as well as the environment (set before any array op)
if os.environ.get("JAX_PLATFORMS", "") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from oceananigans_tpu import (
    FluxBoundaryCondition, Forcing, GridFittedBottom,
    HydrostaticSphericalCoriolis, ImmersedBoundaryGrid,
    LatitudeLongitudeGrid,
)
from oceananigans_tpu.models import HydrostaticFreeSurfaceModel
from oceananigans_tpu.models.hydrostatic import SplitExplicitFreeSurface
from oceananigans_tpu.parallel import DistributedStep

# ---- grid: a mid-latitude basin with a Gaussian seamount -----------------
base = LatitudeLongitudeGrid(size=(64, 32, 8), longitude=(0.0, 360.0),
                             latitude=(15.0, 55.0), z=(-2000.0, 0.0),
                             halo=3)
grid = ImmersedBoundaryGrid(
    base, GridFittedBottom(
        lambda lam, phi: -2000.0 + 1200.0 * jnp.exp(
            -(((lam + 180.0) % 360.0 - 180.0) / 20.0) ** 2
            - ((phi - 35.0) / 8.0) ** 2)))


def make_model(g):
    # zonal wind-stress forcing via a surface momentum flux would use a
    # FluxBoundaryCondition; here a body forcing keeps the demo compact
    tau = Forcing(lambda lam, phi, z, t:
                  1e-6 * jnp.sin(jnp.deg2rad((phi - 15.0) * 4.5)))
    return HydrostaticFreeSurfaceModel(
        grid=g, free_surface=SplitExplicitFreeSurface(substeps=20),
        coriolis=HydrostaticSphericalCoriolis(), tracers=("T",),
        forcing={"u": tau})


devices = jax.devices()
px = 4 if len(devices) >= 8 else max(len(devices) // 2, 1)
py = 2 if len(devices) >= 8 else 1
mesh = Mesh(np.array(devices[:px * py]).reshape(px, py), ("x", "y"))

model = make_model(grid)
dstep = DistributedStep(make_model, grid, mesh)
step = dstep.step_fn()


def validate():
    """CI check: a few distributed steps on the mesh; the wind forcing
    spins up a finite circulation."""
    st = model.initial_state(T=lambda lam, phi, z: 18.0 + 8e-3 * z,
                             eta=lambda lam, phi: 0.0 * lam)
    local = dstep.to_local_state(st)
    for _ in range(3):
        local = step(local, 300.0)
    final = dstep.from_local_state(jax.block_until_ready(local))
    u = np.asarray(jnp.asarray(final.u))
    assert np.isfinite(u).all()
    assert np.abs(u).max() > 0.0


if __name__ == "__main__":
    print(f"mesh: {px}x{py} over {devices[0].platform}")
    state = model.initial_state(
        T=lambda lam, phi, z: 18.0 + 8e-3 * z,
        eta=lambda lam, phi: 0.0 * lam)
    local = dstep.to_local_state(state)

    dt = 300.0
    for n in range(10):
        local = step(local, dt)
    final = dstep.from_local_state(jax.block_until_ready(local))

    u = np.asarray(jnp.asarray(final.u))
    S = grid.interior_slices
    print(f"after {10 * dt / 60:.0f} min: max|u| = {np.abs(u[S]).max():.2e}"
          f" m/s, eta range [{np.asarray(jnp.asarray(final.eta)).min():.2e},"
          f" {np.asarray(jnp.asarray(final.eta)).max():.2e}] m")
    assert np.isfinite(u).all()
    print("distributed ocean demo OK")
