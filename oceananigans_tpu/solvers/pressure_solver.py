"""Pressure-solver auto-selection.

Mirrors the reference's dispatch (``src/Models/NonhydrostaticModels/
NonhydrostaticModels.jl`` `nonhydrostatic_pressure_solver`): fully regular
grid -> FFT; one stretched (z) direction -> Fourier-tridiagonal; immersed
boundaries with stretched spacing -> FFT-preconditioned CG (see
models/nonhydrostatic/pressure.py for the immersed path).
"""

from __future__ import annotations

from oceananigans_tpu.platform import poisson_transform
from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver
from oceananigans_tpu.solvers.fourier_tridiagonal import (
    FourierTridiagonalPoissonSolver,
)
from oceananigans_tpu.solvers.matmul_poisson import MatmulPoissonSolver


def make_pressure_solver(grid):
    from oceananigans_tpu.immersed import (
        ImmersedBoundaryGrid, ImmersedPoissonSolver,
    )
    if isinstance(grid, ImmersedBoundaryGrid):
        return ImmersedPoissonSolver(grid)
    base = getattr(grid, "underlying_grid", grid)
    if base.regular:
        if poisson_transform() == "matmul":
            return MatmulPoissonSolver(base)
        return FFTPoissonSolver(base)
    if base.x_regular and base.y_regular:
        return FourierTridiagonalPoissonSolver(base)
    raise NotImplementedError(
        "stretched x/y directions need the conjugate-gradient Poisson path")
