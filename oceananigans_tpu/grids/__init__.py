"""Grids: geometry + topology for staggered Arakawa C-grids.

Reference layer: ``src/Grids/`` (see SURVEY.md §2.2). Key differences from the
reference, chosen for JAX/XLA:

- Grids are immutable pytrees (``jax.tree_util.register_dataclass``): sizes,
  topology and halo widths are static metadata (hashable, drive tracing);
  coordinate and spacing arrays are ordinary jax array leaves, so a compiled
  step function closes over nothing and reshards cleanly under ``pjit``.
- All per-axis coordinate arrays are stored *broadcast-ready*: x-arrays have
  shape ``(nx_total, 1, 1)``, y ``(1, ny_total, 1)``, z ``(1, 1, nz_total)``.
  Every physics expression is then a whole-array jnp expression; XLA fuses the
  broadcasts into the stencil kernels for free.
- Fields are dense arrays with halo rings (width ``halo`` per non-flat axis).
  Flat axes have size 1 and halo 0 (reference: ``Flat`` topology,
  ``src/Grids/Grids.jl:46-108``).
- Face-located data uses the same array shape as center-located data; on
  Bounded axes the "extra" wall face at index ``H + N`` lives in the first
  halo slot and is maintained by the boundary-condition fill (the reference
  instead sizes face fields N+1: ``src/Grids/grid_utils.jl``).
"""

from oceananigans_tpu.grids.base import (
    Periodic, Bounded, Flat,
    Center, Face,
    AbstractGrid,
    total_length,
)
from oceananigans_tpu.grids.rectilinear import RectilinearGrid
from oceananigans_tpu.grids.latlon import LatitudeLongitudeGrid
from oceananigans_tpu.grids.orthogonal import (
    OrthogonalSphericalShellGrid, TripolarGrid,
    RotatedLatitudeLongitudeGrid,
    rotation_angles, intrinsic_vector, extrinsic_vector,
)
from oceananigans_tpu.grids.cubed_sphere import (
    conformal_cubed_sphere_panel, conformal_cubed_sphere_mapping,
)

__all__ = [
    "Periodic", "Bounded", "Flat", "Center", "Face",
    "AbstractGrid", "RectilinearGrid", "LatitudeLongitudeGrid",
    "OrthogonalSphericalShellGrid", "TripolarGrid",
    "RotatedLatitudeLongitudeGrid",
    "rotation_angles", "intrinsic_vector", "extrinsic_vector",
    "total_length",
]


# ---------------------------------------------------------------------------
# Module-level node/spacing queries (reference
# ``src/Grids/nodes_and_spacings.jl``: nodes, xnodes/ynodes/znodes,
# λnodes/φnodes, xspacings..., minimum_xspacing...). These are thin
# functional wrappers over the grid methods.
# ---------------------------------------------------------------------------

def nodes(grid, locs=(Center, Center, Center), **kw):
    return grid.nodes(locs, **kw) if kw else grid.nodes(locs)


def xnodes(grid, loc=Center, **kw):
    return grid.xnodes(loc, **kw)


def ynodes(grid, loc=Center, **kw):
    return grid.ynodes(loc, **kw)


def znodes(grid, loc=Center, **kw):
    return grid.znodes(loc, **kw)


# On curvilinear (lat-lon, rotated, tripolar) grids the x/y coordinates ARE
# longitude/latitude, so the λ/φ queries alias the x/y ones.
lambda_nodes = λnodes = xnodes
phi_nodes = φnodes = ynodes
rnodes = znodes


def _interior_spacing(grid, d):
    import numpy as _np
    sl = [slice(None)] * 3
    for ax in range(3):
        if _np.shape(d)[ax] > 1:
            sl[ax] = grid.interior_slices[ax]
    return d[tuple(sl)]


def xspacings(grid, lx=Center, ly=Center):
    return _interior_spacing(grid, grid.dx(lx, ly))


def yspacings(grid, ly=Center, lx=Center):
    return _interior_spacing(grid, grid.dy(ly, lx))


def zspacings(grid, lz=Center):
    return _interior_spacing(grid, grid.dz(lz))


lambda_spacings = λspacings = xspacings
phi_spacings = φspacings = yspacings
rspacings = zspacings


def minimum_xspacing(grid):
    return grid.min_spacing(0)


def minimum_yspacing(grid):
    return grid.min_spacing(1)


def minimum_zspacing(grid):
    return grid.min_spacing(2)


__all__ += [
    "nodes", "xnodes", "ynodes", "znodes", "rnodes",
    "lambda_nodes", "phi_nodes",
    "xspacings", "yspacings", "zspacings", "rspacings",
    "lambda_spacings", "phi_spacings",
    "minimum_xspacing", "minimum_yspacing", "minimum_zspacing",
]
