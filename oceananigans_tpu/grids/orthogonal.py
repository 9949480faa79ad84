"""Curvilinear spherical-shell grids: orthogonal shells, rotated lat-lon,
and the tripolar grid with its north-fold Zipper boundary.

Reference: ``src/Grids/orthogonal_spherical_shell_grid.jl:14`` (2-D metric
arrays at all four horizontal staggerings), ``src/
OrthogonalSphericalShellGrids/`` (SURVEY.md §2.18) — ``TripolarGrid``
(``tripolar_grid.jl:11-23``), Murray (1996) cofocal-ellipse coordinates
(``generate_tripolar_coordinates.jl``), ``RotatedLatitudeLongitudeGrid``,
and the Zipper north-fold BC
(``src/BoundaryConditions/fill_halo_regions_zipper.jl``).

Construction is host-side numpy (once); metrics are 2-D broadcastable
arrays consumed by the same operator vocabulary as every other grid.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from oceananigans_tpu.config import config
from oceananigans_tpu.grids.base import (
    AbstractGrid, Bounded, Center, Connected, Face, Flat, Periodic,
    broadcastable, generate_coordinate, register_grid,
)
from oceananigans_tpu.grids.latlon import R_EARTH

__all__ = ["OrthogonalSphericalShellGrid", "TripolarGrid",
           "RotatedLatitudeLongitudeGrid", "ZIPPER_NORTH"]

#: marker used as the y-axis "topology" of grids whose north edge is a
#: tripolar fold (halo filled by the Zipper exchange, not a wall)
ZIPPER_NORTH = "zipper_north"


def _haversine(lam1, phi1, lam2, phi2, radius):
    """Great-circle distance [same units as radius]; inputs in degrees."""
    p1, p2 = np.deg2rad(phi1), np.deg2rad(phi2)
    dl = np.deg2rad(lam2 - lam1)
    dp = p2 - p1
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * radius * np.arcsin(np.minimum(1.0, np.sqrt(a)))


class OrthogonalSphericalShellGrid(AbstractGrid):
    """Fully curvilinear horizontal C-grid: 2-D λ/φ coordinate arrays at
    the four staggerings + 2-D metric arrays, regular or stretched z.

    ``lam_XY``/``phi_XY`` (XY in {ff, fc, cf, cc}) are halo-extended
    (nx, ny) numpy arrays of longitude/latitude in degrees. The y topology
    may be ``Bounded`` or carry the ``zipper`` flag for tripolar folds.
    """

    def __init__(self, lam, phi, z, size, halo=None, radius=R_EARTH,
                 topology=None, zipper=False, dtype=None):
        if dtype is None:
            dtype = config.float_dtype
        dtype = np.dtype(dtype)
        if halo is None:
            halo = config.halo
        Nx, Ny, Nz = size
        Hx = min(halo, Nx)
        Hy = min(halo, Ny)
        if topology is None:
            topology = (Periodic, Bounded, Bounded)
        Hz = 0 if topology[2] == Flat else min(halo, Nz)

        zF, zC, dzC, dzF, z_reg, Lz = generate_coordinate(
            z, Nz, Hz, topology[2], np.float64)

        nx, ny = Nx + 2 * Hx, Ny + 2 * Hy
        for key in ("ff", "fc", "cf", "cc"):
            if lam[key].shape != (nx, ny):
                raise ValueError(f"lam[{key}] must be halo-extended "
                                 f"({nx},{ny}), got {lam[key].shape}")

        # metrics by finite differences of great-circle distances
        # (reference _calculate_metrics!); computed on the full extended
        # arrays — the outermost ring is edge-replicated afterwards
        def dx_from(nodes_lam, nodes_phi, face_offset):
            # face_offset 0: dx at centers from faces i, i+1
            # face_offset 1: dx at faces from centers i-1, i
            d = np.empty((nx, ny))
            if face_offset == 0:
                d[:-1] = _haversine(nodes_lam[:-1], nodes_phi[:-1],
                                    nodes_lam[1:], nodes_phi[1:], radius)
                d[-1] = d[-2]
            else:
                d[1:] = _haversine(nodes_lam[:-1], nodes_phi[:-1],
                                   nodes_lam[1:], nodes_phi[1:], radius)
                d[0] = d[1]
            return d

        def dy_from(nodes_lam, nodes_phi, face_offset):
            d = np.empty((nx, ny))
            if face_offset == 0:
                d[:, :-1] = _haversine(nodes_lam[:, :-1], nodes_phi[:, :-1],
                                       nodes_lam[:, 1:], nodes_phi[:, 1:],
                                       radius)
                d[:, -1] = d[:, -2]
            else:
                d[:, 1:] = _haversine(nodes_lam[:, :-1], nodes_phi[:, :-1],
                                      nodes_lam[:, 1:], nodes_phi[:, 1:],
                                      radius)
                d[:, 0] = d[:, 1]
            return d

        dx_cc = dx_from(lam["fc"], phi["fc"], 0)
        dx_fc = dx_from(lam["cc"], phi["cc"], 1)
        dx_cf = dx_from(lam["ff"], phi["ff"], 0)
        dx_ff = dx_from(lam["cf"], phi["cf"], 1)
        dy_cc = dy_from(lam["cf"], phi["cf"], 0)
        dy_fc = dy_from(lam["ff"], phi["ff"], 0)
        dy_cf = dy_from(lam["cc"], phi["cc"], 1)
        dy_ff = dy_from(lam["fc"], phi["fc"], 1)

        def guard(d):
            # curvilinear degeneracies (poles inside the domain) give zero
            # lengths; floor them to a tiny positive value so divisions
            # stay finite (the zipper/land masks make these cells inert)
            tiny = 1e-3 * np.median(d[d > 0]) if np.any(d > 0) else 1.0
            return np.maximum(d, tiny)

        s = object.__setattr__
        s(self, "Nx", int(Nx)); s(self, "Ny", int(Ny)); s(self, "Nz", int(Nz))
        s(self, "Hx", Hx); s(self, "Hy", Hy); s(self, "Hz", Hz)
        s(self, "topology", tuple(topology))
        s(self, "zipper", bool(zipper))
        s(self, "radius", float(radius))
        s(self, "x_regular", False); s(self, "y_regular", False)
        s(self, "z_regular", bool(z_reg))
        s(self, "Lz", float(Lz))

        def b2(a):
            return jnp.asarray(a.astype(dtype)).reshape(nx, ny, 1)

        def bz(a):
            return broadcastable(a.astype(dtype), 2)

        s(self, "lamFF", b2(lam["ff"])); s(self, "phiFF", b2(phi["ff"]))
        s(self, "lamFC", b2(lam["fc"])); s(self, "phiFC", b2(phi["fc"]))
        s(self, "lamCF", b2(lam["cf"])); s(self, "phiCF", b2(phi["cf"]))
        s(self, "lamCC", b2(lam["cc"])); s(self, "phiCC", b2(phi["cc"]))
        s(self, "dxCC", b2(guard(dx_cc))); s(self, "dxFC", b2(guard(dx_fc)))
        s(self, "dxCF", b2(guard(dx_cf))); s(self, "dxFF", b2(guard(dx_ff)))
        s(self, "dyCC", b2(guard(dy_cc))); s(self, "dyFC", b2(guard(dy_fc)))
        s(self, "dyCF", b2(guard(dy_cf))); s(self, "dyFF", b2(guard(dy_ff)))
        s(self, "zF", bz(zF)); s(self, "zC", bz(zC))
        s(self, "dzC_", bz(dzC)); s(self, "dzF_", bz(dzF))

    # ---- metric interface ----------------------------------------------
    def dx(self, lx=Center, ly=Center):
        return {(Center, Center): self.dxCC, (Face, Center): self.dxFC,
                (Center, Face): self.dxCF, (Face, Face): self.dxFF}[
                    (lx, ly)]

    def dy(self, ly=Center, lx=Center):
        return {(Center, Center): self.dyCC, (Center, Face): self.dyFC,
                (Face, Center): self.dyCF, (Face, Face): self.dyFF}[
                    (ly, lx)]

    def dz(self, lz=Center):
        return self.dzC_ if lz == Center else self.dzF_

    # coordinate aliases for set_field/location_coords
    @property
    def xC(self):
        return self.lamCC

    @property
    def xF(self):
        return self.lamFC

    @property
    def yC(self):
        return self.phiCC

    @property
    def yF(self):
        return self.phiCF

    def nodes_2d(self, loc):
        key = ("f" if loc[0] == Face else "c") + ("f" if loc[1] == Face
                                                  else "c")
        return (getattr(self, f"lam{key.upper()}"),
                getattr(self, f"phi{key.upper()}"))

    def __repr__(self):
        return (f"{type(self).__name__}(size=({self.Nx}, {self.Ny}, "
                f"{self.Nz}), radius={self.radius:g})")


register_grid(
    OrthogonalSphericalShellGrid,
    data_fields=["lamFF", "phiFF", "lamFC", "phiFC", "lamCF", "phiCF",
                 "lamCC", "phiCC", "dxCC", "dxFC", "dxCF", "dxFF",
                 "dyCC", "dyFC", "dyCF", "dyFF", "zF", "zC", "dzC_",
                 "dzF_"],
    meta_fields=["Nx", "Ny", "Nz", "Hx", "Hy", "Hz", "topology", "zipper",
                 "radius", "x_regular", "y_regular", "z_regular", "Lz"],
)


# ---------------------------------------------------------------------------
# Rotated latitude-longitude grid
# ---------------------------------------------------------------------------

def _rotate_coords(lam, phi, north_pole):
    """True (λ, φ) of points given in a rotated system whose north pole
    sits at geographic ``north_pole = (λp, φp)`` (degrees)."""
    lam_p, phi_p = np.deg2rad(north_pole[0]), np.deg2rad(north_pole[1])
    lr, pr = np.deg2rad(lam), np.deg2rad(phi)
    # rotated -> cartesian
    x = np.cos(pr) * np.cos(lr)
    y = np.cos(pr) * np.sin(lr)
    z = np.sin(pr)
    # rotate about y-axis by (90° - φp), then about z-axis by λp
    beta = np.pi / 2 - phi_p
    xb = np.cos(beta) * x + np.sin(beta) * z
    zb = -np.sin(beta) * x + np.cos(beta) * z
    yb = y
    xg = np.cos(lam_p) * xb - np.sin(lam_p) * yb
    yg = np.sin(lam_p) * xb + np.cos(lam_p) * yb
    zg = zb
    phi_g = np.rad2deg(np.arcsin(np.clip(zg, -1, 1)))
    lam_g = np.rad2deg(np.arctan2(yg, xg))
    return lam_g, phi_g


def RotatedLatitudeLongitudeGrid(size, longitude, latitude, z,
                                 north_pole=(0.0, 90.0), radius=R_EARTH,
                                 halo=None, dtype=None):
    """Lat-lon grid in a rotated coordinate system (reference
    ``rotated_latitude_longitude_grid.jl``). ``longitude``/``latitude`` are
    the extents in the ROTATED system; ``north_pole`` is the geographic
    location of the rotated north pole."""
    if halo is None:
        halo = config.halo
    Nx, Ny, Nz = size
    Hx, Hy = min(halo, Nx), min(halo, Ny)
    nx, ny = Nx + 2 * Hx, Ny + 2 * Hy
    dlam = (longitude[1] - longitude[0]) / Nx
    dphi = (latitude[1] - latitude[0]) / Ny
    iF = np.arange(-Hx, Nx + Hx)
    jF = np.arange(-Hy, Ny + Hy)
    lamF = longitude[0] + iF * dlam
    lamC = lamF + dlam / 2
    phiF = latitude[0] + jF * dphi
    phiC = phiF + dphi / 2
    lam, phi = {}, {}
    for key, (l1, p1) in (("ff", (lamF, phiF)), ("fc", (lamF, phiC)),
                          ("cf", (lamC, phiF)), ("cc", (lamC, phiC))):
        L, P = np.meshgrid(l1, p1, indexing="ij")
        lam[key], phi[key] = _rotate_coords(L, P, north_pole)
    span = abs(longitude[1] - longitude[0])
    TX = Periodic if abs(span - 360.0) < 1e-10 else Bounded
    return OrthogonalSphericalShellGrid(
        lam, phi, z, size, halo=halo, radius=radius,
        topology=(TX, Bounded, Bounded), dtype=dtype)


# ---------------------------------------------------------------------------
# Tripolar grid (Murray 1996)
# ---------------------------------------------------------------------------

def TripolarGrid(size, southernmost_latitude=-80.0, z=(-1000.0, 0.0),
                 first_pole_longitude=70.0, focal_distance=0.45,
                 radius=R_EARTH, halo=None, dtype=None):
    """Global tripolar grid: ordinary lat-lon south of the equatorial belt
    and Murray (1996) cofocal-ellipse coordinates toward the two displaced
    north poles (reference ``tripolar_grid.jl:65``,
    ``generate_tripolar_coordinates.jl``). The north edge is a Zipper fold.
    """
    if halo is None:
        halo = config.halo
    Nx, Ny, Nz = size
    Hx, Hy = min(halo, Nx), min(halo, Ny)

    dlam = 360.0 / Nx
    dphi = (90.0 - southernmost_latitude) / Ny
    iF = np.arange(-Hx, Nx + Hx)
    jF = np.arange(-Hy, Ny + Hy)
    lamF = iF * dlam
    lamC = lamF + dlam / 2
    phiF = southernmost_latitude + jF * dphi
    phiC = phiF + dphi / 2

    def murray(lam1d, phi1d):
        """(λ, φ) index grids -> tripolar geographic coordinates."""
        L, P = np.meshgrid(lam1d, phi1d, indexing="ij")
        P = np.minimum(P, 90.0 - 1e-9)
        a = focal_distance
        psi = np.arcsinh(np.tan(np.deg2rad((90.0 - P) / 2)) / a)
        x = a * np.sin(np.deg2rad(L)) * np.cosh(psi)
        y = a * np.cos(np.deg2rad(L)) * np.sinh(psi)
        # exact zeros of sin at multiples of 180° so the hemisphere-
        # boundary columns land on the x = 0 branch deterministically
        x = np.where(np.mod(np.abs(L), 180.0) == 0.0, 0.0, x)
        # NOTE: atan (half-range), not atan2 — the ±90° hemisphere shift
        # below supplies the branch (Murray's formulation). At x = 0 the
        # consistent atan limit is −90° for both boundary columns.
        with np.errstate(divide="ignore", invalid="ignore"):
            lam_g = np.where(
                x == 0, -90.0,
                -180.0 / np.pi * np.arctan(y / np.where(x == 0, 1.0, x)))
        phi_g = 90.0 - 360.0 / np.pi * np.arctan(np.sqrt(x * x + y * y))
        # hemisphere shift decided by the NOMINAL longitude (halo columns
        # included), placing the singularities at first_pole_longitude
        # and first_pole_longitude + 180°
        lam_nom = np.mod(L, 360.0)
        lam_g = lam_g + np.where(lam_nom < 180.0, -90.0, 90.0)
        lam_g = lam_g + first_pole_longitude + 90.0
        lam_g = np.mod(lam_g, 360.0)
        return lam_g, phi_g

    lam, phi = {}, {}
    lam["ff"], phi["ff"] = murray(lamF, phiF)
    lam["fc"], phi["fc"] = murray(lamF, phiC)
    lam["cf"], phi["cf"] = murray(lamC, phiF)
    lam["cc"], phi["cc"] = murray(lamC, phiC)

    grid = OrthogonalSphericalShellGrid(
        lam, phi, z, size, halo=halo, radius=radius,
        topology=(Periodic, Bounded, Bounded), zipper=True, dtype=dtype)
    return grid


# ---------------------------------------------------------------------------
# Zipper north-fold halo fill (reference fill_halo_regions_zipper.jl)
# ---------------------------------------------------------------------------

def fill_zipper_north(a, grid, loc, sign):
    """Fill the north y-halo of a tripolar field by the fold:
    the halo row j = Ny+h maps to the interior row on the opposite side of
    the fold with i reversed; velocity-like fields flip sign.

    Index math (0-based, halo offsets Hx/Hy; derived from the reference's
    1-based ``fold_north_*!`` kernels):
      x-Center: i' = (Nx - 1 - i)
      x-Face:   i' = (Nx - i) mod Nx   (sign unflipped on the wrap column)
      y-Center: halo row Hy+Ny-1+h  <- interior row Hy+Ny-1-h
      y-Face:   halo row Hy+Ny-1+h  <- interior row Hy+Ny-h

    whole-array/distributed form (reference
    ``distributed_tripolar_grid.jl`` exchanges each x-rank with its
    mirror rank): the fold reversal is expressed as ``jnp.flip`` (+
    ``jnp.roll`` by one for x-Face fields) over the halo-extended,
    periodically-pre-filled x axis — ``lax.rev``/``lax.rotate`` partition
    under GSPMD into the same mirror-rank collective permutes, so the
    fill is shardable over an x-partitioned mesh with no gather. Callers
    fill the (periodic) x axis first (``fill_halo_regions`` axis order),
    which makes the flipped extended row its own correctly-wrapped halo
    image."""
    Nx, Ny = grid.Nx, grid.Ny
    Hx, Hy = grid.Hx, grid.Hy
    L = a.shape[0]
    x_face = loc[0] == Face
    y_face = loc[1] == Face

    # folded source plane: flip[i] = a[L-1-i] covers i' = Nx-1-i for
    # x-periodic rows; x-Face adds a +1 rotate (i' = (Nx - i) mod Nx),
    # whose wrapped-around column 0 needs the one periodic correction
    flipped = jnp.flip(a, axis=0)
    i = np.arange(L)
    i_int = (i - Hx) % Nx                      # interior x index 0..Nx-1
    if x_face:
        flipped = jnp.roll(flipped, 1, axis=0)
        if 2 * Hx < L:
            flipped = flipped.at[0].set(a[2 * Hx])
        wrap = (Nx - i_int) == Nx              # i_int == 0 wraps
        sgn = np.where(wrap, abs(sign), sign)
    else:
        sgn = np.full_like(i, sign, dtype=float)
    sgn = jnp.asarray(sgn.reshape(-1, 1), a.dtype)

    out = a
    top = Hy + Ny
    for h in range(1, Hy + 1):
        if y_face:
            j_src = top - h
        else:
            j_src = top - 1 - h
        row = flipped[:, j_src] * sgn
        out = out.at[:, top - 1 + h].set(row)
    if not y_face:
        # the Ny row itself is duplicated across the fold: overwrite its
        # redundant (second) half for consistency
        half = np.asarray(i_int >= Nx // 2).reshape(-1, 1)
        row = flipped[:, top - 1] * sgn
        out = out.at[:, top - 1].set(
            jnp.where(jnp.asarray(half), row, out[:, top - 1]))
    return out


# ---------------------------------------------------------------------------
# Intrinsic <-> extrinsic (geographic) vector rotation (reference
# ``src/Operators/vector_rotation_operators.jl``): on a locally-orthogonal
# curvilinear grid the angle θ between the grid's x-direction and
# geographic east follows from finite differences of the face-node
# latitudes; on lat-lon-aligned parts of the grid cosθ = 1, sinθ = 0.
# ---------------------------------------------------------------------------

def rotation_angles(grid):
    """(cosθ, sinθ) of the grid-to-geographic rotation at cell centers,
    as broadcast-ready (nx, ny, 1) arrays. For grids whose intrinsic
    frame IS geographic (rectilinear, lat-lon) returns (1.0, 0.0)."""
    if not isinstance(grid, OrthogonalSphericalShellGrid):
        return 1.0, 0.0
    from oceananigans_tpu.ops.operators import shift

    d2r = np.pi / 180.0
    ff = grid.phiFF
    ff_p0 = shift(ff, 1, 0)            # (i+1, j)
    ff_0p = shift(ff, 1, 1)            # (i, j+1)
    ff_pp = shift(ff_p0, 1, 1)         # (i+1, j+1)
    dy_m = grid.dy(Center, Face)       # Δy at (x=Face, y=Center)
    dy_p = shift(dy_m, 1, 0)
    dx_m = grid.dx(Center, Face)       # Δx at (x=Center, y=Face)
    dx_p = shift(dx_m, 1, 1)
    Rcos = 0.5 * (d2r * (ff_pp - ff_p0) / dy_p
                  + d2r * (ff_0p - ff) / dy_m)
    # sign convention fixed against geometry (NOT transcribed): with
    # sinθ = +∂φ/∂s_x the grid's own x-direction maps to (1, 0) under
    # intrinsic_vector — verified in tests/test_vector_rotation.py by
    # finite-differencing the geographic coordinates along grid-x.
    Rsin = 0.5 * (d2r * (ff_pp - ff_0p) / dx_p
                  + d2r * (ff_p0 - ff) / dx_m)
    R = jnp.sqrt(Rcos ** 2 + Rsin ** 2)
    R = jnp.maximum(R, jnp.asarray(1e-30, R.dtype))
    return Rcos / R, Rsin / R


def intrinsic_vector(grid, u_e, v_e):
    """Rotate a geographic (east, north) vector field into the grid's
    intrinsic (x, y) frame (reference ``intrinsic_vector``). Angles are
    evaluated at cell centers; for staggered velocities this is the same
    O(Δ) approximation the reference makes."""
    cos, sin = rotation_angles(grid)
    return u_e * cos + v_e * sin, -u_e * sin + v_e * cos


def extrinsic_vector(grid, u_i, v_i):
    """Rotate a grid-intrinsic (x, y) vector field to geographic
    (east, north) components (reference ``extrinsic_vector``) — e.g. for
    writing tripolar-grid velocities in a CF-compliant frame."""
    cos, sin = rotation_angles(grid)
    return u_i * cos - v_i * sin, u_i * sin + v_i * cos


__all__ += ["rotation_angles", "intrinsic_vector", "extrinsic_vector"]
