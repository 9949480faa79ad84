"""FFT-based Poisson solver on regular grids.

Eigenfunction expansion of the 2nd-order staggered Laplacian: forward
transforms (FFT on periodic axes, DCT-II on bounded axes), divide by the sum
of per-axis discrete eigenvalues, zero the mean mode, inverse transforms
(reference ``src/Solvers/fft_based_poisson_solver.jl:95-125`` +
``poisson_eigenvalues.jl``). The transforms are XLA FFT HLOs; DCT is
the permuted-FFT construction in :mod:`transforms` — no host round trips,
the whole solve jit-fuses into the pressure step.

Transform order matters for dtype: DCT (real→real) runs before FFT
(real→complex) on the forward pass and after the inverse FFTs (which produce
Hermitian-symmetric spectra, so taking the real part first is exact).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from oceananigans_tpu.grids.base import Bounded, Connected, Flat, Periodic
from oceananigans_tpu.solvers.transforms import dct2, idct2


def poisson_eigenvalues(N: int, extent_spacing: float, topo: str):
    """Eigenvalues of the 1-D second-order difference operator.

    periodic: λ_k = -(2 sin(πk/N) / Δ)²  (full FFT index ordering)
    bounded : λ_k = -(2 sin(πk/2N) / Δ)² (DCT-II / staggered Neumann)
    (reference ``src/Solvers/poisson_eigenvalues.jl``)
    """
    d = extent_spacing
    k = np.arange(N, dtype=np.float64)
    if topo == Flat:
        return np.zeros(1)
    if topo == Bounded:
        return -((2.0 / d) * np.sin(np.pi * k / (2.0 * N))) ** 2
    return -((2.0 / d) * np.sin(np.pi * k / N)) ** 2


class FFTPoissonSolver:
    """∇²φ = rhs on a fully regular grid; operates on interior-shaped arrays.

    The eigenvalue tables are host numpy constants baked into the jitted
    trace (they are O(N) 1-D arrays, not per-point 3-D fields).
    """

    def __init__(self, grid):
        if not grid.regular:
            raise ValueError("FFTPoissonSolver requires regular spacings on "
                             "every axis; use FourierTridiagonalPoissonSolver")
        self.grid = grid
        self.fft_axes = []
        self.dct_axes = []
        lams = []
        for axis in range(3):
            topo = grid.axis_topo(axis)
            N = grid.N[axis]
            d = (grid.Lx / grid.Nx, grid.Ly / grid.Ny,
                 grid.Lz / grid.Nz)[axis] if topo != Flat else 1.0
            lam = poisson_eigenvalues(N, d, topo)
            shape = [1, 1, 1]
            shape[axis] = lam.shape[0]
            lams.append(lam.reshape(shape))
            if topo in (Periodic, Connected):
                self.fft_axes.append(axis)
            elif topo == Bounded:
                self.dct_axes.append(axis)
        # the first periodic axis uses a REAL transform: the input is real,
        # so its spectrum is Hermitian — rfft halves the data every
        # downstream transform touches (half the device-memory traffic)
        self.rfft_axis = self.fft_axes[0] if self.fft_axes else None
        self.cfft_axes = self.fft_axes[1:]
        if self.rfft_axis is not None:
            ax = self.rfft_axis
            n_half = grid.N[ax] // 2 + 1
            sl = [slice(None)] * 3
            sl[ax] = slice(0, n_half)
            lams = [lam[tuple(sl)] if i == ax else lam
                    for i, lam in enumerate(lams)]
        lam_sum = lams[0] + lams[1] + lams[2]
        # reciprocal with the k=0 (mean) mode zeroed; kept as a numpy
        # constant so it embeds as a literal (never a device-array capture)
        self.inv_lam = np.where(lam_sum == 0, 0.0, 1.0 / np.where(
            lam_sum == 0, 1.0, lam_sum))

    def solve(self, rhs):
        """rhs: interior-shaped (Nx,Ny,Nz) array -> φ with zero mean."""
        dtype = rhs.dtype
        x = rhs
        for axis in self.dct_axes:
            x = dct2(x, axis)
        if self.rfft_axis is not None:
            n_full = x.shape[self.rfft_axis]
            x = jnp.fft.rfft(x, axis=self.rfft_axis)
        for axis in self.cfft_axes:
            x = jnp.fft.fft(x, axis=axis)
        x = x * self.inv_lam.astype(x.real.dtype)
        for axis in self.cfft_axes:
            x = jnp.fft.ifft(x, axis=axis)
        if self.rfft_axis is not None:
            x = jnp.fft.irfft(x, n=n_full, axis=self.rfft_axis)
        x = jnp.real(x)
        for axis in self.dct_axes:
            x = idct2(x, axis)
        return x.astype(dtype)
