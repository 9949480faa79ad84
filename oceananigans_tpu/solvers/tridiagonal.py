"""Batched tridiagonal (Thomas) solve along the z axis.

Reference: ``src/Solvers/batched_tridiagonal_solver.jl:12-46`` launches one
GPU thread per (i,j) column; here the whole (Nx,Ny) batch advances one
z-level per ``lax.scan`` step, so every scan step is a fully vectorized
(Nx,Ny) plane op. Direction-generic via ``axis``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tridiagonal_solve(a, b, c, d, axis: int = -1):
    """Solve ``a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k]`` along ``axis``.

    ``a``/``b``/``c``/``d`` broadcast against each other; ``a[0]`` and
    ``c[N-1]`` are ignored. Returns ``x`` with the broadcast shape.
    """
    a, b, c, d = jnp.broadcast_arrays(a, b, c, d)
    n = d.shape[axis]
    # move the solve axis to the front for scanning
    a_ = jnp.moveaxis(a, axis, 0)
    b_ = jnp.moveaxis(b, axis, 0)
    c_ = jnp.moveaxis(c, axis, 0)
    d_ = jnp.moveaxis(d, axis, 0)

    # forward elimination: c'[k] = c/(b - a c'[k-1]), d' likewise
    def fwd(carry, abcd):
        cp_prev, dp_prev = carry
        ak, bk, ck, dk = abcd
        denom = bk - ak * cp_prev
        cp = ck / denom
        dp = (dk - ak * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zeros = jnp.zeros_like(d_[0])
    (_, _), (cp, dp) = jax.lax.scan(fwd, (zeros, zeros), (a_, b_, c_, d_))

    # back substitution
    def bwd(x_next, cd):
        cpk, dpk = cd
        x = dpk - cpk * x_next
        return x, x

    _, x_rev = jax.lax.scan(bwd, zeros, (cp, dp), reverse=True)
    return jnp.moveaxis(x_rev, 0, axis)
