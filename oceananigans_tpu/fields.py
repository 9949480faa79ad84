"""Fields as plain arrays + location conventions.

Reference layer: ``src/Fields/`` (SURVEY.md §2.5). The reference's
``Field{LX,LY,LZ}`` object (grid + OffsetArray + BCs + lazy operand) is
replaced by plain jax arrays shaped ``grid.shape`` (halo-extended); the
staggered location is carried in *function signatures* (``loc`` tuples) and
variable naming, not in the array. That keeps state pytrees flat and lets
XLA see straight through every access.

Locations of the standard C-grid variables:
    u : (Face,   Center, Center)     w : (Center, Center, Face)
    v : (Center, Face,   Center)     tracers, p, b : (Center, Center, Center)
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu.config import config
from oceananigans_tpu.grids.base import AXIS_NAMES, Center, Face
from oceananigans_tpu.platform import matmul_precision

LOC_U = (Face, Center, Center)
LOC_V = (Center, Face, Center)
LOC_W = (Center, Center, Face)
LOC_C = (Center, Center, Center)


def new_field(grid, dtype=None):
    """A zeroed halo-extended array on ``grid``."""
    if dtype is None:
        dtype = grid.xC.dtype
    return jnp.zeros(grid.shape, dtype)


def location_coords(grid, loc):
    """Broadcast-ready (x, y, z) coordinate arrays at a staggered location."""
    out = []
    for axis, name in enumerate(AXIS_NAMES):
        arr = getattr(grid, f"{name}F" if loc[axis] == Face else f"{name}C")
        out.append(arr)
    return tuple(out)


def set_field(grid, value, loc=LOC_C, dtype=None):
    """Build a field from a number, array (interior-shaped or full), or a
    callable ``f(x, y, z)`` evaluated at the staggered nodes — the functional
    ``set!`` (reference ``src/Fields/set!.jl:26-44``). Halos are left
    unfilled; call ``fill_halo_regions`` afterwards (models do this in
    ``update_state``)."""
    a = new_field(grid, dtype)
    if callable(value):
        x, y, z = location_coords(grid, loc)
        vals = value(x, y, z)
        return jnp.broadcast_to(jnp.asarray(vals, a.dtype), a.shape)
    value = jnp.asarray(value, a.dtype)
    if value.ndim == 0:
        return jnp.full(grid.shape, value, a.dtype)
    if value.shape == tuple(grid.N):
        sx, sy, sz = grid.interior_slices
        return a.at[sx, sy, sz].set(value)
    if value.shape == grid.shape:
        return value
    # allow broadcastable shapes against the interior
    sx, sy, sz = grid.interior_slices
    return a.at[sx, sy, sz].set(jnp.broadcast_to(value, tuple(grid.N)))


def interior(grid, a):
    """Interior view (no halos) — reference ``interior(field)``."""
    return grid.interior(a)


def interior_xy(grid, a):
    """Interior view of a reduced (nx, ny, 1) field (e.g. free surface)."""
    sx, sy, _ = grid.interior_slices
    return a[..., sx, sy, :]


def with_interior(grid, a, values):
    sx, sy, sz = grid.interior_slices
    return a.at[sx, sy, sz].set(values)


# ---------------------------------------------------------------------------
# Reductions over the interior (reference src/Fields/scans.jl + metric
# reductions in src/AbstractOperations/metric_field_reductions.jl)
# ---------------------------------------------------------------------------

def field_sum(grid, a, loc=LOC_C):
    return jnp.sum(interior(grid, a))

def field_max(grid, a):
    return jnp.max(interior(grid, a))

def field_min(grid, a):
    return jnp.min(interior(grid, a))

def field_abs_max(grid, a):
    return jnp.max(jnp.abs(interior(grid, a)))

def field_mean(grid, a, loc=LOC_C):
    """Volume-weighted mean over the interior (reference ``Average``)."""
    V = grid.V(*loc)
    sx, sy, sz = grid.interior_slices
    Vi = jnp.broadcast_to(V, grid.shape)[sx, sy, sz]
    return jnp.sum(interior(grid, a) * Vi) / jnp.sum(Vi)

def field_integral(grid, a, loc=LOC_C):
    V = grid.V(*loc)
    sx, sy, sz = grid.interior_slices
    Vi = jnp.broadcast_to(V, grid.shape)[sx, sy, sz]
    return jnp.sum(interior(grid, a) * Vi)


# ---------------------------------------------------------------------------
# Arbitrary-point interpolation (reference src/Fields/interpolate.jl),
# used by Lagrangian particles and FieldTimeSeries.
# ---------------------------------------------------------------------------

def _overlap_matrix(src_edges, dst_edges):
    """(Nd, Ns) weight matrix: row k holds each source cell's fractional
    overlap with destination cell k (conservative first-order remap)."""
    import numpy as np
    Nd, Ns = len(dst_edges) - 1, len(src_edges) - 1
    W = np.zeros((Nd, Ns))
    for k in range(Nd):
        lo, hi = dst_edges[k], dst_edges[k + 1]
        ov = (np.minimum(hi, src_edges[1:])
              - np.maximum(lo, src_edges[:-1])).clip(min=0.0)
        W[k] = ov / max(hi - lo, 1e-30)
    return W


def _axis_edges(grid, axis):
    import numpy as np
    name = AXIS_NAMES[axis]
    f = np.asarray(getattr(grid, f"{name}F")).reshape(-1)
    H, N = grid.H[axis], grid.N[axis]
    return np.append(f[H:H + N], f[H + N])


def regrid(src_grid, dst_grid, a, loc=LOC_C, axis=2):
    """Conservative regridding along ONE axis between two grids sharing
    the other axes' layout (reference ``src/Fields/regridding_fields.jl``
    ``regrid!``: one direction at a time, overlap-weighted cell averages,
    conserving the metric integral along that axis exactly)."""
    import numpy as np
    W = _overlap_matrix(_axis_edges(src_grid, axis),
                        _axis_edges(dst_grid, axis))
    ai = interior(src_grid, a)
    sub = {0: "sjk,ds->djk", 1: "isk,ds->idk", 2: "ijs,ds->ijd"}[axis]
    out = jnp.einsum(sub, ai, jnp.asarray(W, ai.dtype),
                     precision=matmul_precision(ai.dtype))
    res = new_field(dst_grid, a.dtype)
    sx, sy, sz = dst_grid.interior_slices
    return res.at[sx, sy, sz].set(out)


def regrid_x(src_grid, dst_grid, a, loc=LOC_C):
    return regrid(src_grid, dst_grid, a, loc=loc, axis=0)


def regrid_y(src_grid, dst_grid, a, loc=LOC_C):
    return regrid(src_grid, dst_grid, a, loc=loc, axis=1)


def regrid_z(src_grid, dst_grid, a, loc=LOC_C):
    """Conservative vertical regridding (destination cells receive the
    thickness-weighted overlap average of source cells, conserving
    ∫ a dz per column exactly)."""
    return regrid(src_grid, dst_grid, a, loc=loc, axis=2)


def _fractional_index(xs, x):
    """Continuous index of ``x`` in sorted 1-D coords ``xs`` (halo incl.)."""
    i = jnp.clip(jnp.searchsorted(xs, x, side="right") - 1, 0, xs.size - 2)
    x0 = xs[i]
    x1 = xs[i + 1]
    frac = (x - x0) / jnp.where(x1 == x0, 1.0, x1 - x0)
    return i, jnp.clip(frac, 0.0, 1.0)


def interpolate(grid, a, loc, x, y, z):
    """Trilinear interpolation of field ``a`` (location ``loc``) at point(s)
    ``(x, y, z)``. Works under vmap for particle batches."""
    coords = location_coords(grid, loc)
    idxs, fracs = [], []
    for axis, (carr, q) in enumerate(zip(coords, (x, y, z))):
        c1 = jnp.reshape(carr, (-1,))
        if c1.size == 1:
            idxs.append(jnp.zeros((), jnp.int32))
            fracs.append(jnp.zeros((), a.dtype))
        else:
            i, f = _fractional_index(c1, q)
            idxs.append(i)
            fracs.append(f.astype(a.dtype))
    ix, iy, iz = idxs
    fx, fy, fz = fracs

    def g(dx_, dy_, dz_):
        return a[jnp.minimum(ix + dx_, a.shape[0] - 1),
                 jnp.minimum(iy + dy_, a.shape[1] - 1),
                 jnp.minimum(iz + dz_, a.shape[2] - 1)]

    return ((1 - fx) * (1 - fy) * (1 - fz) * g(0, 0, 0)
            + fx * (1 - fy) * (1 - fz) * g(1, 0, 0)
            + (1 - fx) * fy * (1 - fz) * g(0, 1, 0)
            + fx * fy * (1 - fz) * g(1, 1, 0)
            + (1 - fx) * (1 - fy) * fz * g(0, 0, 1)
            + fx * (1 - fy) * fz * g(1, 0, 1)
            + (1 - fx) * fy * fz * g(0, 1, 1)
            + fx * fy * fz * g(1, 1, 1))


# ---------------------------------------------------------------------------
# Lazy analytic fields (reference ``function_field.jl``,
# ``constant_field.jl``). In the functional design a "lazy field" IS a
# callable of the grid coordinates — these constructors exist for API
# parity and to document that equivalence. They can be passed anywhere a
# field-valued argument is accepted (initial conditions, background
# fields, forcings).
# ---------------------------------------------------------------------------

def FunctionField(fn):
    """A lazy field defined by ``fn(x, y, z)`` (or ``fn(x, y, z, t)``
    where time-dependence is supported, e.g. background fields)."""
    return fn


def ConstantField(value):
    """A lazy field with a uniform value."""
    def fn(*coords):
        return value + 0.0 * coords[0]
    return fn


def ZeroField():
    return ConstantField(0.0)


# ---------------------------------------------------------------------------
# Reference-style field constructors (``src/Fields/field.jl`` Field,
# CenterField/XFaceField/YFaceField/ZFaceField). Fields here are plain
# halo-extended arrays; the constructors are conveniences that build one at
# a staggered location from a number / array / function.
# ---------------------------------------------------------------------------

def Field(grid, value=0.0, loc=LOC_C, dtype=None):
    """A halo-extended array at ``loc`` initialised from ``value``
    (number, interior- or full-shaped array, or ``f(x, y, z)``)."""
    return set_field(grid, value, loc=loc, dtype=dtype)


def CenterField(grid, value=0.0, dtype=None):
    return set_field(grid, value, loc=LOC_C, dtype=dtype)


def XFaceField(grid, value=0.0, dtype=None):
    return set_field(grid, value, loc=LOC_U, dtype=dtype)


def YFaceField(grid, value=0.0, dtype=None):
    return set_field(grid, value, loc=LOC_V, dtype=dtype)


def ZFaceField(grid, value=0.0, dtype=None):
    return set_field(grid, value, loc=LOC_W, dtype=dtype)


class BackgroundField:
    """A background field ``func(x, y, z, t[, parameters])`` for the
    mean-flow decomposition (reference
    ``src/Fields/background_fields.jl:45-58`` — time-dependent, so
    oscillating mean flows are expressible; the model evaluates it at
    the traced clock time each step). ``t`` defaults to 0 so instances
    also work as static ``set_field`` initializers."""

    def __init__(self, func, parameters=None):
        self.func = func
        self.parameters = parameters

    def __call__(self, x, y, z, t=0.0):
        if self.parameters is None:
            return self.func(x, y, z, t)
        return self.func(x, y, z, t, self.parameters)

    def __repr__(self):
        return f"BackgroundField({self.func!r}, parameters={self.parameters!r})"
