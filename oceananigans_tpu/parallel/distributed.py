"""Distributed (multi-device) execution: mesh construction + GSPMD sharding.

Reference layer: ``src/DistributedComputations/`` (SURVEY.md §2.11). The
reference's MPI machinery (ranks, tags, Isend/Irecv, connectivity) maps to
a single ``jax.sharding.Mesh`` with named axes ``("x", "y")`` and GSPMD:

- ``Partition(x, y)``            -> mesh shape (reference
  ``distributed_architectures.jl:15-64``)
- halo exchange                  -> compiler-inserted collective-permutes at
  shard edges (or the explicit path in :mod:`halo_exchange`)
- ``all_reduce``/global norms    -> ``jnp.sum`` on sharded arrays (lowers
  to ``psum``)
- pencil-transpose FFT           -> XLA resharding around the FFT HLO (or
  the explicit ``all_to_all`` path in :mod:`distributed_fft`)
- ``reconstruct_global_grid``    -> trivial: arrays are global jax.Arrays

The reference's interior/halo communication-computation overlap
(``interleave_communication_and_computation.jl``) is handled by XLA's
latency-hiding scheduler.

Multi-host: call ``jax.distributed.initialize()`` before building the
``Distributed`` object and the same code runs multi-controller SPMD across
hosts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["Partition", "Distributed", "shard_state", "sharded_step_fn"]


@dataclasses.dataclass(frozen=True)
class Partition:
    """Domain-decomposition spec (reference
    ``distributed_architectures.jl:15-64``). ``x``/``y`` are ranks per
    direction; None means "fill with the remaining devices" (the reference's
    ``Equal``)."""
    x: Optional[int] = None
    y: Optional[int] = 1

    def resolve(self, n_devices: int):
        x, y = self.x, self.y
        if x is None and y is None:
            x = int(math.floor(math.sqrt(n_devices)))
            while n_devices % x:
                x -= 1
            y = n_devices // x
        elif x is None:
            x = n_devices // y
        elif y is None:
            y = n_devices // x
        if x * y != n_devices:
            raise ValueError(f"Partition({x}, {y}) != {n_devices} devices")
        return x, y


class Distributed:
    """Mesh + sharding helper — the architecture object of the distributed
    path (reference ``Distributed{child_arch}``,
    ``distributed_architectures.jl:167-180``)."""

    def __init__(self, partition: Partition = None, devices=None):
        if devices is None:
            devices = jax.devices()
        partition = partition or Partition()
        px, py = partition.resolve(len(devices))
        self.partition = (px, py)
        self.mesh = Mesh(np.array(devices).reshape(px, py),
                         axis_names=("x", "y"))

    def field_sharding(self):
        """(x, y)-sharded, z replicated — the reference's constraint that z
        stays local (``distributed_fft_based_poisson_solver.jl:49-51``)."""
        return NamedSharding(self.mesh, P("x", "y", None))

    def replicated(self):
        return NamedSharding(self.mesh, P())

    def validate_grid(self, grid):
        px, py = self.partition
        for axis, parts in ((0, px), (1, py)):
            if grid.shape[axis] % parts:
                raise ValueError(
                    f"halo-extended size {grid.shape[axis]} on axis {axis} "
                    f"not divisible by {parts} mesh ranks; choose N so that "
                    f"N + 2H is a multiple of the partition")

    def __repr__(self):
        return f"Distributed(partition={self.partition})"


def shard_state(dist: Distributed, state):
    """Place every 3-D leaf of a state pytree with (x, y) sharding; smaller
    leaves (clock scalars, particle batches) are replicated."""
    fs = dist.field_sharding()
    rep = dist.replicated()

    def place(leaf):
        if getattr(leaf, "ndim", 0) == 3:
            return jax.device_put(leaf, fs)
        return jax.device_put(leaf, rep)

    return jax.tree_util.tree_map(place, state)


def sharded_step_fn(model, dist: Distributed, dt):
    """A jitted step with sharding constraints pinned on inputs/outputs so
    XLA partitions the whole step over the mesh."""
    dist.validate_grid(model.grid)
    fs = dist.field_sharding()

    def constrained(state):
        out = model.step(state, dt)
        return jax.tree_util.tree_map(
            lambda leaf: (jax.lax.with_sharding_constraint(leaf, fs)
                          if getattr(leaf, "ndim", 0) == 3 else leaf),
            out)

    return jax.jit(constrained)
