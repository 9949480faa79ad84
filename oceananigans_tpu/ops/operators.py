"""Discrete calculus on the staggered C-grid, as whole-array shifted ops.

This is the whole-array re-expression of the reference's ~500 inlined
``(i,j,k,grid)`` stencil functions (``src/Operators/``: difference_operators,
interpolation_operators, derivative_operators, divergence/vorticity/laplacian;
see SURVEY.md §2.3). Instead of per-index scalar functions launched inside
kernels, each operator is a pure whole-array expression built from one shift
primitive; XLA fuses arbitrary compositions into a handful of
bandwidth-bound loops — there is no per-point function-call tree to inline.

Staggering convention (reference superscripts ᶜ/ᶠ → suffixes _c/_f):

- ``dx_f(a)`` : x-difference landing on Faces:   out[i] = a[i] - a[i-1]
- ``dx_c(a)`` : x-difference landing on Centers: out[i] = a[i+1] - a[i]
- ``ix_f(a)`` : interpolation onto Faces:        out[i] = (a[i] + a[i-1])/2
- ``ix_c(a)`` : interpolation onto Centers:      out[i] = (a[i+1] + a[i])/2

Arrays carry halo rings; a shift is ``jnp.roll``, which wraps — wrapped
values only land in the outermost halo cells, which the next
``fill_halo_regions`` overwrites, so interior results are always exact.
Flat axes have size 1, making every shift the identity and every difference
identically zero (the reference's ``Flat`` zero-overloads,
``src/Operators/difference_operators.jl`` Flat methods, for free).
"""

from __future__ import annotations

import jax.numpy as jnp

from oceananigans_tpu.grids.base import Center, Face

__all__ = [
    "shift",
    "dx_f", "dx_c", "dy_f", "dy_c", "dz_f", "dz_c",
    "ix_f", "ix_c", "iy_f", "iy_c", "iz_f", "iz_c",
    "ddx_c", "ddx_f", "ddy_c", "ddy_f", "ddz_c", "ddz_f",
    "divergence_ccc", "div_xy_cc", "vorticity_z_ff", "laplacian_ccc",
    "kinetic_energy_cc",
]

X, Y, Z = 0, 1, 2


def shift(a, n: int, axis: int):
    """``out[i] = a[i + n]`` along ``axis`` (wraps; identity on size-1 axes)."""
    if a.ndim < 3 or a.shape[axis] == 1 or n == 0:
        return a
    return jnp.roll(a, -n, axis)


# ---- differences ---------------------------------------------------------

def dx_f(a):
    return a - shift(a, -1, X)


def dx_c(a):
    return shift(a, 1, X) - a


def dy_f(a):
    return a - shift(a, -1, Y)


def dy_c(a):
    return shift(a, 1, Y) - a


def dz_f(a):
    return a - shift(a, -1, Z)


def dz_c(a):
    return shift(a, 1, Z) - a


# ---- interpolations ------------------------------------------------------

def ix_f(a):
    return 0.5 * (a + shift(a, -1, X))


def ix_c(a):
    return 0.5 * (shift(a, 1, X) + a)


def iy_f(a):
    return 0.5 * (a + shift(a, -1, Y))


def iy_c(a):
    return 0.5 * (shift(a, 1, Y) + a)


def iz_f(a):
    return 0.5 * (a + shift(a, -1, Z))


def iz_c(a):
    return 0.5 * (shift(a, 1, Z) + a)


# ---- derivatives (reference derivative_operators.jl) ---------------------

def ddx_f(grid, a, ly=Center):
    """∂/∂x of center-located data, landing on faces."""
    return dx_f(a) / grid.dx(Face, ly)


def ddx_c(grid, a, ly=Center):
    """∂/∂x of face-located data, landing on centers."""
    return dx_c(a) / grid.dx(Center, ly)


def ddy_f(grid, a, lx=Center):
    return dy_f(a) / grid.dy(Face, lx)


def ddy_c(grid, a, lx=Center):
    return dy_c(a) / grid.dy(Center, lx)


def ddz_f(grid, a):
    return dz_f(a) / grid.dz(Face)


def ddz_c(grid, a):
    return dz_c(a) / grid.dz(Center)


# ---- composite operators -------------------------------------------------

def divergence_ccc(grid, u, v, w):
    """Finite-volume divergence at cell centers of a (u,v,w) C-grid vector:
    ``(δx(Ax u) + δy(Ay v) + δz(Az w)) / V`` (reference
    ``src/Operators/divergence_operators.jl`` `div_ccc`)."""
    flux_x = grid.Ax(Face, Center, Center) * u
    flux_y = grid.Ay(Center, Face, Center) * v
    flux_z = grid.Az(Center, Center) * w
    return (dx_c(flux_x) + dy_c(flux_y) + dz_c(flux_z)) / grid.V(
        Center, Center, Center)


def div_xy_cc(grid, u, v):
    """Horizontal divergence at centers (used by free-surface solvers,
    reference `div_xyᶜᶜᶜ`)."""
    flux_x = grid.Ax(Face, Center, Center) * u
    flux_y = grid.Ay(Center, Face, Center) * v
    return (dx_c(flux_x) + dy_c(flux_y)) / grid.V(Center, Center, Center)


def vorticity_z_ff(grid, u, v):
    """Vertical vorticity ζ = (δx(Δy v) − δy(Δx u)) / Az at (Face,Face)
    (reference ``src/Operators/vorticity_operators.jl`` `ζ₃ᶠᶠᶜ`, the
    circulation form that is exact on curvilinear grids).

    The circulation weights each velocity by the edge length AT THE
    VELOCITY'S OWN LOCATION (Δyᶜᶠᶜ for v, Δxᶠᶜᶜ for u — reference
    `ζ₃ᶠᶠᶜ = (δxᶠᶠᶜ(Δyᶜᶠᶜ v) − δyᶠᶠᶜ(Δxᶠᶜᶜ u)) / Azᶠᶠᶜ`), not by the
    (f,f) metrics: on curvilinear grids (cubed-sphere panels near
    corners especially) they differ and the (f,f) choice breaks the
    discrete Stokes identity."""
    return (dx_f(grid.dy(Face, Center) * v) -
            dy_f(grid.dx(Face, Center) * u)) / grid.Az(Face, Face)


def laplacian_ccc(grid, c):
    """∇²c at centers: divergence of the face-staggered gradient."""
    gx = grid.Ax(Face, Center, Center) * dx_f(c) / grid.dx(Face, Center)
    gy = grid.Ay(Center, Face, Center) * dy_f(c) / grid.dy(Face, Center)
    gz = grid.Az(Center, Center) * dz_f(c) / grid.dz(Face)
    return (dx_c(gx) + dy_c(gy) + dz_c(gz)) / grid.V(Center, Center, Center)


def kinetic_energy_cc(grid, u, v, w=None):
    ke = 0.5 * (ix_c(u * u) + iy_c(v * v))
    if w is not None:
        ke = ke + 0.5 * iz_c(w * w)
    return ke
