"""Multi-chip domain decomposition: the same model, sharded over a device
mesh (reference: distributed examples / Reactant sharding,
ext/OceananigansReactantExt/Grids/sharded_grids.jl).

Run on several GPUs (or locally with
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu).
For multi-host, call jax.distributed.initialize() first.
"""

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu import (
    Bounded, BuoyancyTracer, FPlane, Periodic, RectilinearGrid, WENO,
)
from oceananigans_tpu.models import NonhydrostaticModel
from oceananigans_tpu.parallel import Distributed, Partition, shard_state, \
    sharded_step_fn

n = len(jax.devices())
dist = Distributed(Partition(None, None))   # auto-factor the devices
px, py = dist.partition
print(f"{n} devices -> mesh {px} x {py}")

# halo-extended sizes must divide the mesh
H = 3
grid = RectilinearGrid(size=(32 * px - 2 * H, 32 * py - 2 * H, 32),
                       extent=(1.0, 1.0, 1.0),
                       topology=(Periodic, Periodic, Bounded), halo=H)
model = NonhydrostaticModel(grid=grid, advection=WENO(5), tracers=("b",),
                            buoyancy=BuoyancyTracer(),
                            coriolis=FPlane(f=1e-4))
state = model.initial_state(
    u=lambda x, y, z: 0.01 * jnp.sin(2 * np.pi * x),
    b=lambda x, y, z: 1e-5 * z)

state = shard_state(dist, state)
step = sharded_step_fn(model, dist, dt=1e-3)


def validate():
    """CI check: the sharded step runs on the available mesh and stays
    finite."""
    s = step(state)
    s = step(s)
    u = np.asarray(jax.device_get(s.u))
    assert np.isfinite(u).all()


if __name__ == "__main__":
    import time
    state = jax.block_until_ready(step(state))    # compile
    t0 = time.perf_counter()
    for _ in range(20):
        state = step(state)
    jax.block_until_ready(state.u)
    el = (time.perf_counter() - t0) / 20
    pts = grid.Nx * grid.Ny * grid.Nz
    print(f"{el*1e3:.2f} ms/step, {pts/el/1e9:.3f} Gpoints/s "
          f"over {n} devices")
