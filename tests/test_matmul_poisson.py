"""Dense eigenbasis Poisson solver: must agree with the FFT solver to
machine precision on every topology mix."""

import jax.numpy as jnp
import numpy as np
import pytest

from oceananigans_tpu import Bounded, Flat, Periodic, RectilinearGrid
from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver
from oceananigans_tpu.solvers.matmul_poisson import MatmulPoissonSolver


def _check(topology, size):
    kw = {}
    if topology[1] != Flat:
        kw["y"] = (0.0, 0.7)
    grid = RectilinearGrid(size=size, x=(0.0, 1.0), z=(0.0, 0.5),
                           topology=topology, halo=1, **kw)
    rhs = np.random.default_rng(1).standard_normal(
        tuple(grid.N[a] for a in range(3)))
    rhs -= rhs.mean()
    a = np.asarray(FFTPoissonSolver(grid).solve(jnp.asarray(rhs)))
    b = np.asarray(MatmulPoissonSolver(grid).solve(jnp.asarray(rhs)))
    a = a - a.mean()
    b = b - b.mean()
    assert np.abs(a - b).max() < 1e-13 * max(1.0, np.abs(a).max() * 100)


def test_matmul_poisson_ppb():
    _check((Periodic, Periodic, Bounded), (16, 12, 8))


def test_matmul_poisson_pbb():
    _check((Periodic, Bounded, Bounded), (16, 12, 8))


def test_matmul_poisson_all_periodic():
    _check((Periodic, Periodic, Periodic), (16, 12, 8))


def test_matmul_poisson_2d():
    _check((Bounded, Flat, Bounded), (16, 8))


@pytest.mark.parametrize("topology,size", [
    ((Bounded, Periodic, Periodic), (16, 16, 16)),    # nonhydro cells
    ((Periodic, Periodic, Bounded), (16, 16, 16)),    # upstream box
    ((Periodic, Bounded, Bounded), (24, 12, 6)),      # hydro_vi
    ((Bounded, Bounded, Bounded), (8, 12, 10)),
])
def test_fft_matches_matmul_float64_bench_topologies(topology, size):
    """The two transforms ``platform.poisson_transform`` chooses between
    agree in float64 on the topologies the bench cells use."""
    _check(topology, size)


def test_horizontal_basis_matches_fft():
    """The 2-D matmul basis inverts the horizontal Laplacian like the
    DCT/FFT chain of the implicit free surface: forward then inverse is
    the identity, and an eigenmode maps onto one coefficient."""
    from oceananigans_tpu.solvers.matmul_poisson import (
        MatmulHorizontalBasis,
    )
    grid = RectilinearGrid(size=(16, 12, 2), x=(0.0, 1.0), y=(0.0, 0.7),
                           z=(0.0, 1.0),
                           topology=(Periodic, Bounded, Bounded), halo=1)
    basis = MatmulHorizontalBasis(grid)
    x = np.random.default_rng(2).standard_normal((16, 12, 1))
    back = np.asarray(basis.inverse(basis.forward(jnp.asarray(x))))
    np.testing.assert_allclose(back, x, atol=1e-13)
    xs = np.arange(16) / 16    # the basis rows are cos(2πki/N)
    ys = (np.arange(12) + 0.5) * 0.7 / 12
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    mode = (np.cos(2 * np.pi * 2 * X) * np.cos(np.pi * 3 * Y / 0.7))
    coef = np.asarray(basis.forward(jnp.asarray(mode[..., None])))
    assert (np.abs(coef) > 1e-9).sum() == 1


def test_matmul_poisson_single_mode_exact():
    """A discrete Laplacian eigenmode solves exactly: φ = rhs/λ."""
    N = 32
    grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                           topology=(Periodic, Periodic, Bounded),
                           halo=(0, 0, 1))
    xs = (np.arange(N) + 0.5) / N
    X, _, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    d = 1.0 / N
    mode = np.sin(2 * np.pi * 3 * X) * np.cos(np.pi * 4 * Z)
    lam = -(2 / d ** 2) * ((1 - np.cos(2 * np.pi * 3 / N))
                           + (1 - np.cos(np.pi * 4 / N)))
    phi = np.asarray(MatmulPoissonSolver(grid).solve(jnp.asarray(mode)))
    np.testing.assert_allclose(phi, mode / lam, atol=1e-11)
