"""Field operations and derived diagnostics: the AbstractOperations analog.

Reference layer: ``src/AbstractOperations/`` (SURVEY.md §2.6). The
reference builds *lazy* expression trees (UnaryOperation/BinaryOperation/
Derivative/`@at`) that a `compute!` pass materializes on GPU. Under XLA the
laziness is free: any composition of the functions below fuses inside the
jitted caller, so the analog here is plain functions over arrays —
`KernelFunctionOperation` ≡ "write a function", `ComputedField` caching ≡
XLA common-subexpression elimination.

Locations are explicit arguments (like the reference's `@at`); metric
weighting uses the grid's Δ/A/V vocabulary.
"""

from __future__ import annotations

import jax.numpy as jnp

from oceananigans_tpu.fields import LOC_C, interior
from oceananigans_tpu.grids.base import Center, Face
from oceananigans_tpu.ops.operators import (
    ddx_c, ddx_f, ddy_c, ddy_f, ddz_c, ddz_f,
    divergence_ccc, ix_c, ix_f, iy_c, iy_f, iz_c, iz_f,
    kinetic_energy_cc, laplacian_ccc, vorticity_z_ff,
)

__all__ = [
    "dx", "dy", "dz", "at",
    "Average", "Integral", "CumulativeIntegral", "ConditionalAverage",
    "Reduction", "Accumulation", "KernelFunctionOperation",
    "vertical_vorticity", "kinetic_energy", "divergence", "laplacian",
    "speed",
]

X, Y, Z = 0, 1, 2


# ---------------------------------------------------------------------------
# Derivatives with explicit locations (reference ∂x/∂y/∂z operators)
# ---------------------------------------------------------------------------

def dx(grid, a, loc=LOC_C):
    """∂a/∂x; result moves to the complementary x-staggering."""
    return (ddx_f(grid, a, loc[1]) if loc[0] == Center
            else ddx_c(grid, a, loc[1]))


def dy(grid, a, loc=LOC_C):
    return (ddy_f(grid, a, loc[0]) if loc[1] == Center
            else ddy_c(grid, a, loc[0]))


def dz(grid, a, loc=LOC_C):
    return ddz_f(grid, a) if loc[2] == Center else ddz_c(grid, a)


_INTERPS = {(Center, Face): (ix_f, iy_f, iz_f),
            (Face, Center): (ix_c, iy_c, iz_c)}


def at(grid, a, from_loc, to_loc):
    """Interpolate ``a`` from one staggered location to another (the
    reference's ``@at`` / auto-interpolation,
    ``AbstractOperations.jl:44-50``)."""
    for axis in range(3):
        key = (from_loc[axis], to_loc[axis])
        if key in _INTERPS:
            a = _INTERPS[key][axis](a)
    return a


# ---------------------------------------------------------------------------
# Metric reductions (reference metric_field_reductions.jl: Average/Integral)
# ---------------------------------------------------------------------------

def _weights(grid, loc, dims):
    w = 1.0
    if X in dims:
        w = w * grid.dx(loc[0], loc[1])
    if Y in dims:
        w = w * grid.dy(loc[1], loc[0])
    if Z in dims:
        w = w * grid.dz(loc[2])
    return jnp.broadcast_to(w, grid.shape)


def _norm_dims(dims):
    if dims is None:
        return (X, Y, Z)
    if isinstance(dims, int):
        return (dims,)
    return tuple(dims)


def Average(grid, a, dims=None, loc=LOC_C, condition=None):
    """Metric-weighted mean over ``dims`` of the interior."""
    dims = _norm_dims(dims)
    w = interior(grid, _weights(grid, loc, dims))
    ai = interior(grid, a)
    if condition is not None:
        cond = interior(grid, condition)
        w = jnp.where(cond, w, 0.0)
    num = jnp.sum(ai * w, axis=dims, keepdims=True)
    den = jnp.sum(w + jnp.zeros_like(ai), axis=dims, keepdims=True)
    return num / den


def Integral(grid, a, dims=None, loc=LOC_C):
    dims = _norm_dims(dims)
    w = interior(grid, _weights(grid, loc, dims))
    return jnp.sum(interior(grid, a) * w, axis=dims, keepdims=True)


def CumulativeIntegral(grid, a, dim=Z, loc=LOC_C):
    w = interior(grid, _weights(grid, loc, (dim,)))
    return jnp.cumsum(interior(grid, a) * w, axis=dim)


def ConditionalAverage(grid, a, condition, dims=None, loc=LOC_C):
    """Masked average — the reference's ``ConditionalOperation`` +
    reduction (``conditional_operations.jl:8``)."""
    return Average(grid, a, dims=dims, loc=loc, condition=condition)


def Reduction(op, grid, a, dims=None):
    """Reduce the interior of ``a`` with ``op`` (e.g. ``jnp.max``,
    ``jnp.sum``) over ``dims`` — the reference's generic
    ``Reduction(reduce!, operand; dims)`` (``src/Fields/field.jl``).
    Metric-weighted reductions are :func:`Average` / :func:`Integral`."""
    dims = _norm_dims(dims)
    return op(interior(grid, a), axis=dims, keepdims=True)


def Accumulation(op, grid, a, dims=Z):
    """Accumulate the interior of ``a`` with a cumulative ``op``
    (e.g. ``jnp.cumsum``, ``jnp.cummax``) along ``dims`` — the reference's
    ``Accumulation(accumulate!, operand; dims)``. The metric-weighted
    form is :func:`CumulativeIntegral`."""
    if not isinstance(dims, int):
        (dims,) = _norm_dims(dims)
    return op(interior(grid, a), axis=dims)


def KernelFunctionOperation(func, grid, *args, **kwargs):
    """Evaluate ``func(grid, *args, **kwargs)`` — the analog of the
    reference's ``KernelFunctionOperation{LX, LY, LZ}(kernel_function,
    grid, args...)`` (``abstract_operations.jl``). There is no lazy
    wrapper: XLA fuses the whole-array expression wherever the result is
    consumed, which is what the reference's lazy tree achieves at
    ``compute!`` time."""
    return func(grid, *args, **kwargs)


# ---------------------------------------------------------------------------
# Common derived fields (the reference's stock KernelFunctionOperations)
# ---------------------------------------------------------------------------

def vertical_vorticity(grid, u, v):
    """ζ at (f,f,c)."""
    return vorticity_z_ff(grid, u, v)


def kinetic_energy(grid, u, v, w=None):
    """½|u|² at centers."""
    return kinetic_energy_cc(grid, u, v, w)


def speed(grid, u, v, w=None):
    return jnp.sqrt(2.0 * kinetic_energy_cc(grid, u, v, w))


def divergence(grid, u, v, w):
    return divergence_ccc(grid, u, v, w)


def laplacian(grid, c):
    return laplacian_ccc(grid, c)
