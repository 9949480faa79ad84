"""Explicit halo exchange: shard_map + ppermute neighbor collectives.

Reference: ``src/DistributedComputations/halo_communication.jl`` — the MPI
Isend/Irecv halo exchange with structured tags. Equivalent here: each
shard sends its edge strips to its mesh neighbors with
``jax.lax.ppermute`` (nearest-neighbor hops), all
inside ``shard_map``. No tags or requests: ordering is compiler-scheduled.

This is the *explicit* path, for code that wants materialized local
halos (SURVEY.md §7 design stance). The default model path instead
uses GSPMD: whole-array stencils on sharded arrays compile to the same
collective-permutes automatically.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

__all__ = ["halo_exchange", "halo_exchange_spec",
           "to_local_layout", "from_local_layout"]


# ---------------------------------------------------------------------------
# Local-halos layout: each shard's block carries its OWN halo strips (the
# layout a shard-local stencil consumes), unlike the model's global layout where
# only the domain edges have halo slots. Shapes:
#   global interior (Nx, Ny, Nz)  <->  local layout (px·(nxl+2Hx), ...)
# ---------------------------------------------------------------------------

def to_local_layout(a_interior, mesh: Mesh, grid):
    """Block the global interior over the mesh and pad per-block halo slots
    (filled with zeros; call :func:`halo_exchange` to populate them)."""
    px, py = mesh.shape["x"], mesh.shape["y"]
    Nx, Ny, Nz = a_interior.shape
    Hx, Hy = grid.Hx, grid.Hy
    nxl, nyl = Nx // px, Ny // py
    a = a_interior.reshape(px, nxl, py, nyl, Nz)
    a = jnp.pad(a, ((0, 0), (Hx, Hx), (0, 0), (Hy, Hy), (0, 0)))
    a = a.reshape(px * (nxl + 2 * Hx), py * (nyl + 2 * Hy), Nz)
    return jax.device_put(a, NamedSharding(mesh, P("x", "y", None)))


def from_local_layout(a_local, mesh: Mesh, grid, interior_shape):
    """Strip per-block halos back to the global interior array."""
    px, py = mesh.shape["x"], mesh.shape["y"]
    Nx, Ny, Nz = interior_shape
    Hx, Hy = grid.Hx, grid.Hy
    nxl, nyl = Nx // px, Ny // py
    a = a_local.reshape(px, nxl + 2 * Hx, py, nyl + 2 * Hy, Nz)
    a = a[:, Hx:Hx + nxl, :, Hy:Hy + nyl, :]
    return a.reshape(Nx, Ny, Nz)


def _exchange_axis(local, axis_name, axis, h, periodic, axis_size):
    """Exchange h-wide edge strips with ± neighbors along one mesh axis.

    ``local``: the local block INCLUDING its halo slots (width h at each
    end of ``axis``). Interior strips are sent; received strips overwrite
    the halo slots.
    """
    if h == 0 or axis_size == 1:
        return local
    n = local.shape[axis]

    def axsl(sl):
        out = [slice(None)] * local.ndim
        out[axis] = sl
        return tuple(out)

    # strips adjacent to the halo region (our edge interior cells)
    send_left = local[axsl(slice(h, 2 * h))]          # -> left neighbor
    send_right = local[axsl(slice(n - 2 * h, n - h))]  # -> right neighbor

    fwd = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    bwd = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    if not periodic:
        fwd = [(s, d) for s, d in fwd if d != 0]
        bwd = [(s, d) for s, d in bwd if d != axis_size - 1]

    # right halo receives the right neighbor's left-edge strip (data moves
    # backward); left halo receives the left neighbor's right-edge strip
    recv_right = jax.lax.ppermute(send_left, axis_name, bwd)
    recv_left = jax.lax.ppermute(send_right, axis_name, fwd)

    local = local.at[axsl(slice(0, h))].set(recv_left)
    local = local.at[axsl(slice(n - h, n))].set(recv_right)
    return local


def halo_exchange(a, mesh: Mesh, grid, axes=("x", "y")):
    """Fill the x/y halo rings of a (x, y)-sharded halo-extended global
    array by neighbor exchange. Periodic wrap follows the grid topology.

    The global array layout matches the single-chip one (N + 2H per axis);
    each shard owns a contiguous block whose outermost strips are halo
    cells of the *global* array only at the domain edges — interior shard
    edges hold neighbor data after this exchange.
    """
    from oceananigans_tpu.grids.base import Periodic

    specs = P("x", "y", None)

    @partial(shard_map, mesh=mesh, in_specs=specs, out_specs=specs)
    def exch(local):
        out = local
        for axis, name in ((0, "x"), (1, "y")):
            if name not in axes:
                continue
            h = grid.H[axis]
            periodic = grid.axis_topo(axis) == Periodic
            out = _exchange_axis(out, name, axis, h, periodic,
                                 mesh.shape[name])
        return out

    return exch(a)


def halo_exchange_spec(mesh):
    """The PartitionSpec used by :func:`halo_exchange`."""
    return NamedSharding(mesh, P("x", "y", None))
