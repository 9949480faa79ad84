"""Explicit stencil-matrix (hepta/pentadiagonal) iterative solver.

Reference: ``src/Solvers/heptadiagonal_iterative_solver.jl:12`` +
``matrix_solver_utils.jl`` — a sparse 7-diagonal matrix assembled from
grid metrics, solved with a preconditioned Krylov method, used by the
``MatrixImplicitFreeSurfaceSolver``
(``matrix_implicit_free_surface_solver.jl:18``).

Design: no sparse formats. The seven diagonals are DENSE
per-cell coefficient arrays and the matvec is seven fused multiply-adds
with shifted operands (``jnp.roll``) — a layout that vectorizes;
sparse gather/scatter would defeat XLA vectorization. The preconditioner
is the inverse diagonal (Jacobi), the reference's default-strength
choice (its SPAI option approximates the same thing).
"""

from __future__ import annotations

import jax.numpy as jnp

from oceananigans_tpu.solvers.conjugate_gradient import conjugate_gradient

__all__ = ["StencilMatrix", "HeptadiagonalIterativeSolver"]


def _shift(a, off, axis, periodic):
    """a shifted so result[i] = a[i+off] along ``axis``; non-periodic
    axes get zeros shifted in (the coefficient arrays are also zero at
    walls, so either convention is consistent)."""
    out = jnp.roll(a, -off, axis)
    if not periodic:
        n = a.shape[axis]
        idx = [slice(None)] * a.ndim
        if off > 0:
            idx[axis] = slice(n - off, n)
        else:
            idx[axis] = slice(0, -off)
        out = out.at[tuple(idx)].set(0.0)
    return out


class StencilMatrix:
    """A symmetric 7-diagonal operator on (nx, ny, nz) arrays:

        (A x)[ijk] = D[ijk] x[ijk]
                   + ax[i+1] (x[i+1] − x[i]) − ax[i] (x[i] − x[i−1])
                   + (same in y with ay, z with az)

    assembled from FACE coefficient arrays ``ax, ay, az`` (the flux
    conductances; zero on solid walls) and a cell ``extra`` diagonal
    term. This guarantees symmetry, so CG applies."""

    def __init__(self, ax=None, ay=None, az=None, extra=0.0,
                 periodic=(False, False, False)):
        self.ax, self.ay, self.az = ax, ay, az
        self.extra = extra
        self.periodic = tuple(periodic)

    def diagonal(self):
        d = jnp.zeros_like(
            self.ax if self.ax is not None else
            (self.ay if self.ay is not None else self.az))
        for a, axis in ((self.ax, 0), (self.ay, 1), (self.az, 2)):
            if a is None:
                continue
            d = d - a - _shift(a, 1, axis, self.periodic[axis])
        return d + self.extra

    def __call__(self, x):
        out = x * self.extra
        for a, axis in ((self.ax, 0), (self.ay, 1), (self.az, 2)):
            if a is None:
                continue
            per = self.periodic[axis]
            xp = _shift(x, 1, axis, per)
            xm = _shift(x, -1, axis, per)
            ap = _shift(a, 1, axis, per)
            out = out + ap * (xp - x) - a * (x - xm)
        return out


class HeptadiagonalIterativeSolver:
    """Preconditioned CG on a :class:`StencilMatrix` (reference
    ``heptadiagonal_iterative_solver.jl``).

    ``preconditioner``:
      - ``"jacobi"`` — inverse diagonal (the reference's default-strength
        choice);
      - ``"spai"`` (or an int polynomial degree k >= 1) — truncated
        Neumann-series approximate inverse
        M = (I + N + ... + N^k) D⁻¹ with N = I − D⁻¹A: the dense
        analog of the reference's sparse approximate inverse
        (``sparse_approximate_inverse.jl`` builds an explicit sparse
        M ≈ A⁻¹ applied as a sparse matvec; here the approximate inverse
        is applied as k extra dense-stencil matvecs, which is the form
        that vectorizes — no sparse gather/scatter). Symmetric, and
        positive-definite for the diagonally-dominant conductance
        stencils this solver sees, so CG theory still applies.
        ``"spai"`` uses k = 2; an ILU analog is deliberately absent
        (triangular solves serialize — wrong shape for the hardware).
    """

    def __init__(self, matrix: StencilMatrix, maxiter=500, reltol=1e-10,
                 preconditioner="jacobi"):
        self.matrix = matrix
        self.maxiter = maxiter
        self.reltol = reltol
        d = matrix.diagonal()
        self._inv_diag = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d),
                                   0.0)
        if preconditioner == "spai":
            preconditioner = 2
        self._poly_degree = (int(preconditioner)
                             if not isinstance(preconditioner, str) else 0)

    def _precondition(self, r):
        y = r * self._inv_diag
        for _ in range(self._poly_degree):
            # y <- D⁻¹ r + (I − D⁻¹A) y  (Horner form of Σ N^j D⁻¹ r)
            y = r * self._inv_diag + y - self.matrix(y) * self._inv_diag
        return y

    def solve(self, b, x0=None):
        x0 = jnp.zeros_like(b) if x0 is None else x0
        x, it, res = conjugate_gradient(
            self.matrix, b, x0,
            preconditioner=self._precondition,
            maxiter=self.maxiter, reltol=self.reltol)
        return x, it, res
