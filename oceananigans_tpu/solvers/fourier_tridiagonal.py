"""Fourier-tridiagonal Poisson solver: FFT/DCT in x,y + Thomas solve in
(possibly stretched) z.

Reference: ``src/Solvers/fourier_tridiagonal_poisson_solver.jl:6``. The
vertical finite-volume operator is exact on stretched z; each transformed
horizontal mode (kx,ky) yields an independent tridiagonal system, solved for
all modes at once by the batched scan in :mod:`tridiagonal` (z stays local
on a chip — the reference makes the same locality assumption,
``distributed_fft_based_poisson_solver.jl:49-51``).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from oceananigans_tpu.grids.base import Bounded, Connected, Flat, Periodic
from oceananigans_tpu.solvers.fft_poisson import poisson_eigenvalues
from oceananigans_tpu.solvers.transforms import dct2, idct2
from oceananigans_tpu.solvers.tridiagonal import tridiagonal_solve


class FourierTridiagonalPoissonSolver:
    """∇²φ = rhs with stretched z; x and y must be regular."""

    def __init__(self, grid):
        if not (grid.x_regular and grid.y_regular):
            raise ValueError("x and y must be regular (stretched handled "
                             "only in z)")
        self.grid = grid
        self.fft_axes, self.dct_axes = [], []
        lams = []
        for axis in (0, 1):
            topo = grid.axis_topo(axis)
            N = grid.N[axis]
            d = (grid.Lx / grid.Nx, grid.Ly / grid.Ny)[axis] \
                if topo != Flat else 1.0
            lam = poisson_eigenvalues(N, d, topo)
            shape = [1, 1, 1]
            shape[axis] = lam.shape[0]
            lams.append(lam.reshape(shape))
            if topo in (Periodic, Connected):
                self.fft_axes.append(axis)
            elif topo == Bounded:
                self.dct_axes.append(axis)
        self.lam_h = lams[0] + lams[1]        # (Nx,Ny,1) horizontal eigenvalues

        # vertical FV coefficients from interior spacings (host constants)
        Hz, Nz = grid.Hz, grid.Nz
        dzc = np.asarray(grid.dz(lz="c")).reshape(-1)[Hz:Hz + Nz]   # cell heights
        dzf = np.asarray(grid.dz(lz="f")).reshape(-1)[Hz:Hz + Nz + 1]
        # dzf[k] = distance between centers k-1,k ; lower coupling of cell k
        a = np.zeros(Nz)
        c = np.zeros(Nz)
        a[1:] = 1.0 / dzf[1:Nz]
        c[:-1] = 1.0 / dzf[1:Nz]
        self.az = a.reshape(1, 1, Nz)
        self.cz = c.reshape(1, 1, Nz)
        self.dzc = dzc.reshape(1, 1, Nz)

    def solve(self, rhs):
        dtype = rhs.dtype
        x = rhs
        for axis in self.dct_axes:
            x = dct2(x, axis)
        for axis in self.fft_axes:
            x = jnp.fft.fft(x, axis=axis)

        rdt = x.real.dtype
        # numpy constants combined with a traced zero so only the SMALL
        # per-axis literals are embedded (not a full 3-D constant)
        zero = jnp.real(x[:1, :1, :1]) * 0
        lam_h = zero + self.lam_h.astype(rdt)
        az = zero + self.az.astype(rdt)
        cz = zero + self.cz.astype(rdt)
        dzc = zero + self.dzc.astype(rdt)
        b = -(az + cz) + lam_h * dzc
        # project the nullspace component out of the singular (λ_h = 0)
        # column so the pure-Neumann system is exactly compatible even under
        # numerical drift of the RHS
        singular_col = lam_h == 0
        col_mean = (jnp.sum(x * dzc, axis=2, keepdims=True) / jnp.sum(dzc))
        x = jnp.where(singular_col, x - col_mean, x)
        d = x * dzc

        # the λ_h = 0 column is singular (pure Neumann in z): pin φ(k=0)=0 by
        # replacing its first row with the identity
        Nz = self.grid.Nz
        k0 = jnp.arange(Nz).reshape(1, 1, Nz) == 0
        singular = lam_h == 0
        b = jnp.where(singular & k0, 1.0, b)
        czs = jnp.where(singular & k0, 0.0, cz)
        d = jnp.where(singular & k0, 0.0, d)

        if jnp.iscomplexobj(d):
            phi = (tridiagonal_solve(az, b, czs, d.real, axis=2)
                   + 1j * tridiagonal_solve(az, b, czs, d.imag, axis=2))
        else:
            phi = tridiagonal_solve(az, b, czs, d, axis=2)

        for axis in self.fft_axes:
            phi = jnp.fft.ifft(phi, axis=axis)
        phi = jnp.real(phi)
        for axis in self.dct_axes:
            phi = idct2(phi, axis)
        # remove the volume mean (gauge) so results match the FFT solver
        w = dzc / jnp.sum(dzc)
        mean = jnp.sum(jnp.mean(phi, axis=(0, 1), keepdims=True) * w)
        return (phi - mean).astype(dtype)
