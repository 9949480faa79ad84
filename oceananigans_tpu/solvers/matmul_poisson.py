"""Poisson solver with transforms as dense matrix products.

Reference capability: ``fft_based_poisson_solver.jl`` (same separable
eigenfunction method). A length-N transform is an N×N matrix: each axis
is transformed by an ORTHONORMAL real basis of 1-D Laplacian
eigenvectors (DCT-II for Bounded/Neumann axes, the real Fourier
cos/sin basis for Periodic axes), so the inverse transform is the
transpose and everything stays real: the whole solve is six einsums and
one elementwise multiply, 2·N⁴ flops each on an N³ grid. Which of this
and the FFT chain a platform uses is decided in ``platform.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from oceananigans_tpu.grids.base import Bounded, Connected, Flat, Periodic

from oceananigans_tpu.platform import matmul_precision

__all__ = ["MatmulPoissonSolver"]


def _bounded_basis(N, d):
    """Orthonormal DCT-II rows T[k, i] and the staggered-grid Laplacian
    eigenvalues (Neumann): λ_k = -(2/d²)(1 - cos(πk/N))."""
    i = np.arange(N)
    k = np.arange(N)[:, None]
    T = np.cos(np.pi * (i[None, :] + 0.5) * k / N) * np.sqrt(2.0 / N)
    T[0] /= np.sqrt(2.0)
    lam = -(2.0 / d ** 2) * (1.0 - np.cos(np.pi * np.arange(N) / N))
    return T, lam


def _periodic_basis(N, d):
    """Orthonormal real-Fourier rows (const, cos k, sin k, Nyquist) and
    the periodic staggered Laplacian eigenvalues
    λ = -(2/d²)(1 - cos(2πk/N)) (cos and sin rows share λ_k)."""
    i = np.arange(N)
    rows = [np.full(N, 1.0 / np.sqrt(N))]
    lam = [0.0]

    def lam_k(k):
        return -(2.0 / d ** 2) * (1.0 - np.cos(2.0 * np.pi * k / N))

    for k in range(1, N // 2):
        rows.append(np.sqrt(2.0 / N) * np.cos(2 * np.pi * k * i / N))
        lam.append(lam_k(k))
        rows.append(np.sqrt(2.0 / N) * np.sin(2 * np.pi * k * i / N))
        lam.append(lam_k(k))
    if N % 2 == 0 and N > 1:
        rows.append(np.cos(np.pi * i) / np.sqrt(N))
        lam.append(lam_k(N // 2))
    return np.stack(rows), np.asarray(lam)


class MatmulPoissonSolver:
    """∇²φ = rhs on a fully regular grid via per-axis orthonormal
    eigenbasis matmuls; operates on interior-shaped arrays (drop-in for
    ``FFTPoissonSolver``)."""

    def __init__(self, grid):
        if not grid.regular:
            raise ValueError("MatmulPoissonSolver requires regular "
                             "spacings on every axis")
        self.grid = grid
        self.T = []       # per-axis (N, N) numpy transform or None (Flat)
        lams = []
        for axis in range(3):
            topo = grid.axis_topo(axis)
            N = grid.N[axis]
            if topo == Flat or N == 1:
                self.T.append(None)
                lams.append(np.zeros((1,)))
                continue
            d = (grid.Lx / grid.Nx, grid.Ly / grid.Ny,
                 grid.Lz / grid.Nz)[axis]
            if topo in (Periodic, Connected):
                T, lam = _periodic_basis(N, d)
            elif topo == Bounded:
                T, lam = _bounded_basis(N, d)
            else:
                raise ValueError(f"unsupported topology {topo}")
            self.T.append(T)
            lams.append(lam)
        shape = lambda a, n: [(1, 1, 1)[:a] + (n,) + (1, 1)[a:]][0]
        lam_sum = sum(l.reshape([n if i == a else 1
                                 for i, n in enumerate((len(lams[0]),
                                                        len(lams[1]),
                                                        len(lams[2])))])
                      for a, l in enumerate(lams))
        self.inv_lam = np.where(lam_sum == 0, 0.0,
                                1.0 / np.where(lam_sum == 0, 1.0, lam_sum))
        #: matmul precision: "auto" takes the platform's choice
        #: (``platform.matmul_precision``), or an explicit lax.Precision
        self.precision = "auto"

    def _precision(self, dtype):
        if self.precision != "auto":
            return self.precision
        return matmul_precision(dtype)

    def _apply(self, x, axis, transpose):
        T = self.T[axis]
        if T is None:
            return x
        M = T.T if transpose else T
        M = M.astype(np.dtype(x.dtype))
        sub = "ai,ijk->ajk" if axis == 0 else (
            "aj,ijk->iak" if axis == 1 else "ak,ijk->ija")
        return jnp.einsum(sub, M, x, precision=self._precision(x.dtype))

    def solve(self, rhs):
        """rhs: interior-shaped (Nx, Ny, Nz) -> φ with zero mean."""
        x = rhs
        for axis in range(3):
            x = self._apply(x, axis, transpose=False)
        x = x * self.inv_lam.astype(x.dtype)
        for axis in range(3):
            x = self._apply(x, axis, transpose=True)
        return x


class MatmulHorizontalBasis:
    """2-D horizontal eigen-transform via matmul bases, for the implicit
    free-surface Helmholtz solve on platforms whose
    ``platform.poisson_transform`` is "matmul"."""

    def __init__(self, grid):
        self.T = []
        lams = []
        for axis in (0, 1):
            topo = grid.axis_topo(axis)
            N = grid.N[axis]
            if topo == Flat or N == 1:
                self.T.append(None)
                lams.append(np.zeros(max(N, 1)))
                continue
            d = (grid.Lx / grid.Nx, grid.Ly / grid.Ny)[axis]
            if topo in (Periodic, Connected):
                T, lam = _periodic_basis(N, d)
            elif topo == Bounded:
                T, lam = _bounded_basis(N, d)
            else:
                raise ValueError(f"unsupported topology {topo}")
            self.T.append(T)
            lams.append(lam)
        #: (Nx, Ny, 1) eigenvalues of the horizontal Laplacian
        self.lam2d = (lams[0][:, None, None] + lams[1][None, :, None])
        self.precision = "auto"

    def _precision(self, dtype):
        if self.precision != "auto":
            return self.precision
        return matmul_precision(dtype)

    def _apply(self, x, axis, transpose):
        T = self.T[axis]
        if T is None:
            return x
        M = (T.T if transpose else T).astype(np.dtype(x.dtype))
        sub = "ai,ijk->ajk" if axis == 0 else "aj,ijk->iak"
        return jnp.einsum(sub, M, x, precision=self._precision(x.dtype))

    def forward(self, x):
        return self._apply(self._apply(x, 0, False), 1, False)

    def inverse(self, x):
        return self._apply(self._apply(x, 0, True), 1, True)
