"""Fast cosine transforms via permuted FFTs.

XLA has no native DCT; bounded (wall) directions of the Poisson problem need
DCT-II/III (staggered-grid Neumann eigenfunctions). We use the Makhoul
single-N trick: an even/odd index permutation plus an N-point complex FFT and
a twiddle, so a bounded-direction transform costs the same FFT the periodic
direction does. The reference reaches the same transform through cuFFT with
index permutations (``src/Solvers/discrete_transforms.jl``,
``index_permutations.jl``); the math here is derived independently (standard
Makhoul 1980 construction, verified exact in tests/test_transforms.py).

Conventions (unnormalized, matching the eigenvalue solver):
    dct2(x)_k  = 2 Σ_n x_n cos(πk(2n+1)/(2N))      (forward, "DCT-II")
    idct2 is its exact inverse (a scaled DCT-III).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def _perm_indices(N: int):
    """v = x[perm] with perm = [0, 2, 4, ..., 5, 3, 1]."""
    evens = np.arange(0, N, 2)
    odds = np.arange(1, N, 2)[::-1]
    perm = np.concatenate([evens, odds])
    inv = np.empty(N, np.int64)
    inv[perm] = np.arange(N)
    return perm, inv


# NOTE: all constants below stay numpy and are passed straight into jnp
# ops, which embeds them as literals at lowering.

def dct2(x, axis: int):
    """Unnormalized DCT-II along ``axis`` (real in, real out)."""
    N = x.shape[axis]
    perm, _ = _perm_indices(N)
    v = jnp.take(x, perm, axis=axis)
    V = jnp.fft.fft(v, axis=axis)
    k = np.arange(N)
    w = 2.0 * np.exp(-1j * np.pi * k / (2 * N))
    shape = [1] * x.ndim
    shape[axis] = N
    return jnp.real(w.reshape(shape) * V)


def idct2(X, axis: int):
    """Exact inverse of :func:`dct2` (real in, real out)."""
    N = X.shape[axis]
    k = np.arange(N)
    w = 0.5 * np.exp(1j * np.pi * k / (2 * N))
    shape = [1] * X.ndim
    shape[axis] = N
    # X_rev_k = X_{N-k} with X_rev_0 = 0 (Hermitian reconstruction)
    Xrev = jnp.concatenate(
        [jnp.zeros_like(jnp.take(X, np.array([0]), axis=axis)),
         jnp.flip(jnp.take(X, np.arange(1, N), axis=axis), axis=axis)],
        axis=axis)
    V = w.reshape(shape) * (X - 1j * Xrev)
    v = jnp.real(jnp.fft.ifft(V, axis=axis))
    _, inv = _perm_indices(N)
    return jnp.take(v, inv, axis=axis)
