"""Six-panel conformal cubed-sphere grid with inter-panel halo exchange.

Reference: ``src/MultiRegion/cubed_sphere_grid.jl`` +
``cubed_sphere_connectivity.jl`` + ``cubed_sphere_partitions.jl``
(SURVEY.md §2.17). The reference builds a MultiRegion of 6 panels with
hand-coded rotated connectivity; here the layout here is a STACKED
panel axis — fields are (6, nx, ny, nz) arrays, panel-local operators
``vmap`` over the leading axis — and the connectivity (which neighbor
panel, which side, index order, velocity-component rotation) is derived
NUMERICALLY by matching edge node coordinates between panels, which
eliminates the orientation-bug class entirely.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu.config import config
from oceananigans_tpu.grids.base import Face
from oceananigans_tpu.grids.cubed_sphere import (
    conformal_cubed_sphere_mapping,
)
from oceananigans_tpu.grids.latlon import R_EARTH
from oceananigans_tpu.grids.orthogonal import OrthogonalSphericalShellGrid

__all__ = ["ConformalCubedSphereGrid", "cubed_sphere_halo_exchange"]

# rotations taking the TOP panel onto the 6 cube faces
_PANEL_ROTATIONS = [
    np.eye(3),                                           # 0: +z (top)
    np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]]).T,      # 1: +x
    np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]]).T,      # 2: +y
    np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]]).T,      # 3: -x
    np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]]).T,      # 4: -y
    np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]]),       # 5: -z (bottom)
]

_SIDES = ("west", "east", "south", "north")


def _panel_xyz(p, x, y):
    """Cartesian points of panel p at panel coordinates (x, y)."""
    X, Y, Z = conformal_cubed_sphere_mapping(x, y)
    P = np.stack([X, Y, Z], axis=-1)
    return P @ np.asarray(_PANEL_ROTATIONS[p]).T


def _edge_nodes(p, side, N, offset):
    """(N,) cartesian nodes along an interior line ``offset`` cells inside
    ``side`` of panel p (offset 0 = on the edge), at cell-center spacing."""
    t = -1.0 + (2.0 / N) * (np.arange(N) + 0.5)
    d = 2.0 / N
    if side == "west":
        x = np.full(N, -1.0 + offset * d)
        y = t
    elif side == "east":
        x = np.full(N, 1.0 - offset * d)
        y = t
    elif side == "south":
        x = t
        y = np.full(N, -1.0 + offset * d)
    else:
        x = t
        y = np.full(N, 1.0 - offset * d)
    return _panel_xyz(p, x, y)


@lru_cache(None)
def _connectivity(N: int):
    """For each (panel, side): (neighbor_panel, neighbor_side, reversed).

    Derived by matching the ON-EDGE node sets numerically."""
    conn = {}
    edges = {(p, s): _edge_nodes(p, s, N, 0.0)
             for p in range(6) for s in _SIDES}
    for (p, s), pts in edges.items():
        for (q, r), qts in edges.items():
            if q == p:
                continue
            if np.allclose(pts, qts, atol=1e-10):
                conn[(p, s)] = (q, r, False)
                break
            if np.allclose(pts, qts[::-1], atol=1e-10):
                conn[(p, s)] = (q, r, True)
                break
        if (p, s) not in conn:
            raise RuntimeError(f"no neighbor found for panel {p} side {s}")
    return conn


class ConformalCubedSphereGrid:
    """Six conformal panels + numeric connectivity. Fields live as
    (6, nx, ny, nz) stacked arrays; ``panel_grid`` is the shared
    per-panel OrthogonalSphericalShellGrid (all panels are congruent)."""

    def __init__(self, panel_size, z, radius=R_EARTH, halo=None,
                 dtype=None):
        from oceananigans_tpu.grids.cubed_sphere import (
            conformal_cubed_sphere_panel,
        )
        if halo is None:
            halo = min(config.halo, 2)
        N, Nz = panel_size
        self.N_panel = N
        self.panel_grid = conformal_cubed_sphere_panel(
            (N, N, Nz), z=z, radius=radius, halo=halo, dtype=dtype)
        self.connectivity = _connectivity(N)
        self.rotations = _PANEL_ROTATIONS

        # per-panel geographic coordinates at centers (for set_field-style
        # initialization)
        g = self.panel_grid
        t = -1.0 + (2.0 / N) * (np.arange(N) + 0.5)
        XX, YY = np.meshgrid(t, t, indexing="ij")
        lams, phis = [], []
        for p in range(6):
            P = _panel_xyz(p, XX.ravel(), YY.ravel()).reshape(N, N, 3)
            phis.append(np.rad2deg(np.arcsin(np.clip(P[..., 2], -1, 1))))
            lams.append(np.rad2deg(np.arctan2(P[..., 1], P[..., 0])))
        self.lam_cc = np.stack(lams)    # (6, N, N)
        self.phi_cc = np.stack(phis)

    def new_field(self, dtype=None):
        g = self.panel_grid
        return jnp.zeros((6, *g.shape),
                         dtype or np.dtype(config.float_dtype))

    def set_tracer(self, fn):
        """Build a (6, nx, ny, nz) tracer from ``fn(lam, phi, z)``
        (degrees; z broadcast)."""
        g = self.panel_grid
        full = np.zeros((6, *g.shape))
        sx, sy, sz = g.interior_slices
        zc = np.asarray(g.zC).reshape(-1)[sz] if g.shape[2] > 1 else \
            np.zeros(g.Nz)
        for p in range(6):
            vals = fn(self.lam_cc[p][:, :, None],
                      self.phi_cc[p][:, :, None],
                      zc[None, None, :])
            full[p][sx, sy, sz] = vals
        return jnp.asarray(full, config.float_dtype)

    # ---- Simulation / writer interface (stacked-panel semantics) ------
    @property
    def N(self):
        """(N, N, Nz) per-panel interior sizes (writer metadata)."""
        g = self.panel_grid
        return (self.N_panel, self.N_panel, g.Nz)

    @property
    def interior_slices(self):
        return self.panel_grid.interior_slices

    def interior(self, a):
        """Interior view of a stacked (6, nx, ny, nz) field (the panel
        axis passes through; per-panel halos drop; size-1 reduced axes —
        e.g. eta's z — pass through)."""
        return self.panel_grid.interior(a)

    def xnodes(self, *a, **kw):
        """Cell-center longitudes, flattened (6·N·N,) — curvilinear
        grids have no separable 1-D x coordinate."""
        return np.asarray(self.lam_cc).ravel()

    def ynodes(self, *a, **kw):
        return np.asarray(self.phi_cc).ravel()

    def znodes(self, *a, **kw):
        return self.panel_grid.znodes(*a, **kw)

    def __repr__(self):
        return (f"ConformalCubedSphereGrid(panels=6, "
                f"N={self.N_panel}, Nz={self.panel_grid.Nz})")


def panel_geographic_coords(xs, ys):
    """(longitude, latitude) in degrees at the panel-coordinate tensor
    grid ``(xs, ys)`` for all six panels: (6, len(xs), len(ys)) arrays.
    The single source of truth for staggered geographic coordinates
    (used by the hydrostatic model's forcing/BC evaluation AND the
    NetCDF writer's coordinate variables — keep them identical)."""
    XX, YY = np.meshgrid(np.asarray(xs, float), np.asarray(ys, float),
                         indexing="ij")
    lam = np.zeros((6,) + XX.shape)
    phi = np.zeros((6,) + XX.shape)
    for p in range(6):
        P = _panel_xyz(p, XX.ravel(), YY.ravel()).reshape(*XX.shape, 3)
        phi[p] = np.rad2deg(np.arcsin(np.clip(P[..., 2], -1.0, 1.0)))
        lam[p] = np.rad2deg(np.arctan2(P[..., 1], P[..., 0]))
    return lam, phi


def _tangent(p, x, y, axis, h=1e-6):
    """Unit tangent of panel p's grid direction at panel coords (x, y)."""
    if axis == 0:
        d = _panel_xyz(p, np.atleast_1d(x + h), np.atleast_1d(y)) \
            - _panel_xyz(p, np.atleast_1d(x - h), np.atleast_1d(y))
    else:
        d = _panel_xyz(p, np.atleast_1d(x), np.atleast_1d(y + h)) \
            - _panel_xyz(p, np.atleast_1d(x), np.atleast_1d(y - h))
    d = d[0]
    return d / np.linalg.norm(d)


@lru_cache(None)
def _velocity_maps(N: int, H: int):
    """Numerically-derived gather maps for the staggered velocity halo
    exchange: for every halo slot of every panel side, which neighbor
    panel/component/index supplies it and with which sign (the
    velocity-component rotation across rotated panel edges).

    Arrays follow the framework's CO-SHAPED field convention
    (``AbstractGrid.shape``): every field is (N+2H, N+2H, nz) and a
    face field's meaningful faces are i in [H, H+N] (the shared panel
    edge face at H+N is interior-owned, never overwritten here).

    Maps are exact because the conformal panels share their staggered
    point lattices along edges (verified to ~1e-15 in tests)."""
    d = 2.0 / N
    Hx = Hy = H

    def coords(comp, i, j):
        """Panel coords of staggered point (array indices i, j)."""
        if comp == "u":
            return -1.0 + (i - Hx) * d, -1.0 + (j - Hy + 0.5) * d
        return -1.0 + (i - Hx + 0.5) * d, -1.0 + (j - Hy) * d

    # source tables: interior staggered points of every panel
    src_pts = {}
    src_idx = {}
    for comp in ("u", "v"):
        if comp == "u":
            ii = np.arange(Hx, Hx + N + 1)      # x-faces incl shared edge
            jj = np.arange(Hy, Hy + N)
        else:
            ii = np.arange(Hx, Hx + N)
            jj = np.arange(Hy, Hy + N + 1)
        I, J = np.meshgrid(ii, jj, indexing="ij")
        x, y = coords(comp, I.ravel().astype(float),
                      J.ravel().astype(float))
        src_idx[comp] = (I.ravel(), J.ravel())
        src_pts[comp] = {p: _panel_xyz(p, x, y) for p in range(6)}

    conn = _connectivity(N)
    maps = {}
    for p in range(6):
        for side in _SIDES:
            q = conn[(p, side)][0]
            for comp in ("u", "v"):
                # halo slots of this side (transverse range: interior)
                if side in ("west", "east"):
                    if side == "west":
                        ih = np.arange(0, Hx)
                    else:
                        ih = np.arange(Hx + N + (1 if comp == "u" else 0),
                                       2 * Hx + N + (1 if comp == "u"
                                                     else 0))
                        ih = ih[ih < 2 * Hx + N + 1]
                    jh = np.arange(Hy, Hy + N + (1 if comp == "v" else 0))
                else:
                    ih = np.arange(Hx, Hx + N + (1 if comp == "u" else 0))
                    if side == "south":
                        jh = np.arange(0, Hy)
                    else:
                        jh = np.arange(Hy + N + (1 if comp == "v" else 0),
                                       2 * Hy + N + (1 if comp == "v"
                                                     else 0))
                        jh = jh[jh < 2 * Hy + N + 1]
                I, J = np.meshgrid(ih, jh, indexing="ij")
                I = I.ravel()
                J = J.ravel()
                # clip to the co-shaped array extent (N+2H per axis);
                # east/north slots for the face-normal component start
                # past the interior-owned edge face at H+N
                ni = nj = 2 * Hx + N
                keep = (I < ni) & (J < nj)
                I, J = I[keep], J[keep]
                if I.size == 0:
                    continue
                x, y = coords(comp, I.astype(float), J.astype(float))
                P = _panel_xyz(p, x, y)
                # match against neighbor's u and v tables
                out_comp = np.empty(I.size, dtype="U1")
                out_i = np.zeros(I.size, np.int32)
                out_j = np.zeros(I.size, np.int32)
                out_s = np.zeros(I.size)
                for m in range(I.size):
                    best = None
                    for sc in ("u", "v"):
                        dist = np.linalg.norm(src_pts[sc][q] - P[m],
                                              axis=1)
                        k = int(np.argmin(dist))
                        if best is None or dist[k] < best[0]:
                            best = (dist[k], sc, k)
                    dist_k, sc, k = best
                    # tolerance: staggered points from different panels'
                    # corner series agree to the conformal-fit residual
                    # (~1e-7), far below the grid spacing
                    if dist_k > 1e-5:
                        raise RuntimeError(
                            f"no staggered match p{p} {side} {comp} "
                            f"(dist {dist_k:.2e})")
                    iq = int(src_idx[sc][0][k])
                    jq = int(src_idx[sc][1][k])
                    # sign: project the source component's tangent onto the
                    # receiving component's tangent
                    t_dst = _tangent(p, x[m], y[m], 0 if comp == "u" else 1)
                    xs, ys = coords(sc, float(iq), float(jq))
                    t_src = _tangent(q, xs, ys, 0 if sc == "u" else 1)
                    s = float(np.round(t_dst @ t_src))
                    if s == 0.0:
                        raise RuntimeError("non-orthogonal edge rotation")
                    out_comp[m] = sc
                    out_i[m] = iq
                    out_j[m] = jq
                    out_s[m] = s
                maps[(p, side, comp)] = (q, I, J, out_comp, out_i, out_j,
                                         out_s)
    return maps


@lru_cache(None)
def corner_circulation_tables(N: int, H: int):
    """Exact 3-segment circulation stencils for the vertical vorticity at
    the 8 cube-corner vertices (each panel's 4 corners are cube corners).

    The standard 4-segment C-grid circulation is wrong there: the vertex
    is 3-valent, so the loop through the four surrounding "cell centers"
    references a fictitious quadrant and double-samples one edge.
    Instead we integrate around the spherical TRIANGLE through the three
    REAL adjacent cell centers; each leg crosses one emanating edge at a
    staggered velocity point, whose slot/sign is found numerically (the
    same position-matching used for the velocity halo exchange).

    Returns (corners, comp, ii, jj, w, area):
      corners: list of 4 (ci, cj) vertex indices,
      comp[c]: (6, 3) 0=u/1=v slot of each leg's sample,
      ii/jj[c]: (6, 3) array indices,
      w[c]: (6, 3) signed UNIT-SPHERE leg lengths,
      area[c]: (6,) unit-sphere triangle areas.
    ζ_corner = Σ_k w_k · vel_k / (area · radius)."""
    d = 2.0 / N

    def cc_xy(i, j):
        return -1.0 + (i - H + 0.5) * d, -1.0 + (j - H + 0.5) * d

    def slot_xy(comp, i, j):
        if comp == 0:    # u at (f, c)
            return -1.0 + (i - H) * d, -1.0 + (j - H + 0.5) * d
        return -1.0 + (i - H + 0.5) * d, -1.0 + (j - H) * d

    def tri_area(A, B, C):
        # l'Huilier on the unit sphere
        def side(P, Q):
            return np.arccos(np.clip(np.dot(P, Q), -1.0, 1.0))
        a_, b_, c_ = side(B, C), side(C, A), side(A, B)
        s = 0.5 * (a_ + b_ + c_)
        t = np.sqrt(max(np.tan(s / 2) * np.tan((s - a_) / 2)
                        * np.tan((s - b_) / 2) * np.tan((s - c_) / 2), 0.0))
        return 4.0 * np.arctan(t)

    corners = [(H, H), (H + N, H), (H, H + N), (H + N, H + N)]
    comp_t, ii_t, jj_t, w_t, area_t = [], [], [], [], []
    for (ci, cj) in corners:
        di = 1 if ci == H else -1
        dj = 1 if cj == H else -1
        # the three real cell centers around the vertex: own + the two
        # edge-strip cells (their extension positions match the true
        # neighbor centers)
        own = (ci - (0 if di > 0 else 1), cj - (0 if dj > 0 else 1))
        cx = (own[0] - di, own[1])
        cy = (own[0], own[1] - dj)
        # candidate staggered slots adjacent to the vertex
        cands = [(0, ci, cj - (0 if dj > 0 else 1)),
                 (0, ci, cj - (1 if dj > 0 else 0)),
                 (1, ci - (0 if di > 0 else 1), cj),
                 (1, ci - (1 if di > 0 else 0), cj)]
        comp_p = np.zeros((6, 6), np.int32)
        ii_p = np.zeros((6, 6), np.int32)
        jj_p = np.zeros((6, 6), np.int32)
        w_p = np.zeros((6, 6))
        area_p = np.zeros(6)
        def at(p, xy):
            return _panel_xyz(p, np.atleast_1d(xy[0]),
                              np.atleast_1d(xy[1]))[0]

        for p in range(6):
            P = {c: at(p, cc_xy(*c)) for c in (own, cx, cy)}
            # counterclockwise (w.r.t. outward normal) vertex order
            order = [own, cx, cy]
            n = P[own] / np.linalg.norm(P[own])
            if np.dot(np.cross(P[cx] - P[own], P[cy] - P[own]), n) < 0:
                order = [own, cy, cx]
            area_p[p] = tri_area(*(P[c] for c in order))
            for k in range(3):
                A, B = P[order[k]], P[order[(k + 1) % 3]]
                mid = 0.5 * (A + B)
                mid /= np.linalg.norm(mid)
                leg = B - A
                leg = leg / np.linalg.norm(leg)
                # among the slots at this leg's crossing point, pick the
                # component whose direction is ALONG the leg (two slots
                # can alias the same physical point with different
                # component directions; only the leg-normal one carries
                # the circulation contribution)
                best = None
                for (sc, si, sj) in cands:
                    sp = at(p, slot_xy(sc, si, sj))
                    if np.linalg.norm(sp - mid) > 0.45 * d:
                        continue
                    t = _tangent(p, *slot_xy(sc, si, sj), sc)
                    al = abs(np.dot(t, leg))
                    if best is None or al > best[0]:
                        best = (al, sc, si, sj, t)
                if best is None or best[0] < 0.95:
                    raise RuntimeError(
                        f"corner leg sample ambiguous (align "
                        f"{0 if best is None else best[0]:.3f})")
                _, sc, si, sj, t = best
                s = 1.0 if np.dot(t, leg) > 0 else -1.0
                L = np.arccos(np.clip(np.dot(A / np.linalg.norm(A),
                                             B / np.linalg.norm(B)),
                                      -1.0, 1.0))
                # ONE-point quadrature at the staggered sample is O(1)
                # wrong for zeta: the sample sits off the leg's true
                # edge-crossing radius and the circulation is a small
                # residual. Interpolate the edge-normal velocity to the
                # exact chord/edge crossing from the TWO samples along
                # the emanating edge.
                vx, vy = -1.0 + (ci - H) * d, -1.0 + (cj - H) * d
                Pv = at(p, (vx, vy))
                # second sample: one step farther from the vertex along
                # the same edge line
                opts = ([(sc, si, sj + 1), (sc, si, sj - 1)]
                        if sc == 0 else
                        [(sc, si + 1, sj), (sc, si - 1, sj)])
                def arcd(Q, R):
                    return np.arccos(np.clip(
                        np.dot(Q / np.linalg.norm(Q),
                               R / np.linalg.norm(R)), -1.0, 1.0))
                P0 = at(p, slot_xy(sc, si, sj))
                cand2 = max(opts,
                            key=lambda o: arcd(at(p, slot_xy(*o)), Pv))
                P1 = at(p, slot_xy(*cand2))
                # chord/edge crossing: nearest point of the edge sample
                # line to the chord (both curves are smooth; minimize
                # pointwise distance)
                ts = np.linspace(0.0, 1.0, 801)
                chord = (1 - ts)[:, None] * A + ts[:, None] * B
                chord /= np.linalg.norm(chord, axis=1, keepdims=True)
                rs = np.linspace(0.0, 3.0, 1201)
                e0 = np.array(slot_xy(sc, si, sj))
                e1 = np.array(slot_xy(*cand2))
                exy = e0[None, :] + (e1 - e0)[None, :] * (
                    (rs - 0.5) / 1.0)[:, None] / 1.0
                E = _panel_xyz(p, exy[:, 0], exy[:, 1])
                E /= np.linalg.norm(E, axis=1, keepdims=True)
                dm = np.linalg.norm(chord[:, None, :] - E[None, :, :],
                                    axis=2)
                ic, ie = np.unravel_index(np.argmin(dm), dm.shape)
                X = E[ie]
                s0 = arcd(P0, Pv)
                s1 = arcd(P1, Pv)
                sxd = arcd(X, Pv)
                c1 = (sxd - s0) / (s1 - s0)
                c0 = 1.0 - c1
                comp_p[p, 2 * k] = sc
                ii_p[p, 2 * k] = si
                jj_p[p, 2 * k] = sj
                w_p[p, 2 * k] = s * L * c0
                comp_p[p, 2 * k + 1] = cand2[0]
                ii_p[p, 2 * k + 1] = cand2[1]
                jj_p[p, 2 * k + 1] = cand2[2]
                w_p[p, 2 * k + 1] = s * L * c1
        comp_t.append(comp_p)
        ii_t.append(ii_p)
        jj_t.append(jj_p)
        w_t.append(w_p)
        area_t.append(area_p)
    return corners, comp_t, ii_t, jj_t, w_t, area_t


@lru_cache(None)
def _edge_face_maps(N: int, H: int):
    """Match every panel's EDGE faces (the face-normal component slots
    lying ON each panel boundary) to the neighbor panel's matching edge
    faces, with the component-rotation sign. Used to make fluxes through
    shared faces single-valued (exact global conservation)."""
    d = 2.0 / N

    def slot_xy(comp, i, j):
        if comp == 0:
            return -1.0 + (i - H) * d, -1.0 + (j - H + 0.5) * d
        return -1.0 + (i - H + 0.5) * d, -1.0 + (j - H) * d

    conn = _connectivity(N)
    # neighbor candidate table: all edge-face slots of every panel
    cand = {}
    for q in range(6):
        slots = []
        for i in (H, H + N):
            for j in range(H, H + N):
                slots.append((0, i, j))
        for j in (H, H + N):
            for i in range(H, H + N):
                slots.append((1, i, j))
        xy = np.array([slot_xy(*s) for s in slots])
        cand[q] = (slots, _panel_xyz(q, xy[:, 0], xy[:, 1]))

    maps = []
    for p in range(6):
        for side in _SIDES:
            q = conn[(p, side)][0]
            if side == "west":
                own = [(0, H, j) for j in range(H, H + N)]
            elif side == "east":
                own = [(0, H + N, j) for j in range(H, H + N)]
            elif side == "south":
                own = [(1, i, H) for i in range(H, H + N)]
            else:
                own = [(1, i, H + N) for i in range(H, H + N)]
            oc = np.array([o[0] for o in own])
            oi = np.array([o[1] for o in own])
            oj = np.array([o[2] for o in own])
            xy = np.array([slot_xy(*o) for o in own])
            P = _panel_xyz(p, xy[:, 0], xy[:, 1])
            qslots, qpts = cand[q]
            nc = np.zeros(len(own), np.int32)
            ni = np.zeros(len(own), np.int32)
            nj = np.zeros(len(own), np.int32)
            sg = np.zeros(len(own))
            for m in range(len(own)):
                dist = np.linalg.norm(qpts - P[m], axis=1)
                k = int(np.argmin(dist))
                if dist[k] > 1e-5:
                    raise RuntimeError(
                        f"edge-face match failed p{p} {side} ({dist[k]:.1e})")
                sc, si, sj = qslots[k]
                t_own = _tangent(p, *slot_xy(*own[m]), own[m][0])
                t_src = _tangent(q, *slot_xy(sc, si, sj), sc)
                s = float(np.round(np.dot(t_own, t_src)))
                if s == 0.0:
                    raise RuntimeError("edge-face rotation not ±1")
                nc[m], ni[m], nj[m], sg[m] = sc, si, sj, s
            maps.append((p, oc, oi, oj, q, nc, ni, nj, sg))
    return maps


@lru_cache(None)
def _edge_face_maps_flat(N: int, H: int):
    """All (panel, side) edge-face tables concatenated into one flat
    table (4 gathers + 2 scatters instead of ~24 per-side updates)."""
    maps = _edge_face_maps(N, H)
    PP, OC, OI, OJ, QQ, NC, NI, NJ, SG = ([] for _ in range(9))
    for (p, oc, oi, oj, q, nc, ni, nj, sg) in maps:
        PP.append(np.full(oi.size, p))
        OC.append(oc)
        OI.append(oi)
        OJ.append(oj)
        QQ.append(np.full(oi.size, q))
        NC.append(nc)
        NI.append(ni)
        NJ.append(nj)
        SG.append(sg)
    return tuple(np.concatenate(v) for v in
                 (PP, OC, OI, OJ, QQ, NC, NI, NJ, SG))


def cubed_sphere_sync_edge_fluxes(Fx, Fy, grid):
    """Make the x/y fluxes through shared panel-edge faces single-valued:
    both panels' values are replaced by the (rotation-consistent) mean,
    so the flux leaving one panel is EXACTLY the flux entering its
    neighbor — global conservation to machine precision (the reference
    achieves this by sharing face fluxes in its multi-region fill)."""
    g = grid.panel_grid
    PP, OC, OI, OJ, QQ, NC, NI, NJ, SG = _edge_face_maps_flat(
        grid.N_panel, g.Hx)
    own_u = Fx[PP, OI, OJ, :]
    own_v = Fy[PP, OI, OJ, :]
    own = jnp.where(jnp.asarray(OC == 0)[:, None], own_u, own_v)
    oth_u = Fx[QQ, NI, NJ, :]
    oth_v = Fy[QQ, NI, NJ, :]
    oth = jnp.where(jnp.asarray(NC == 0)[:, None], oth_u, oth_v)
    mean = 0.5 * (own + jnp.asarray(SG, own.dtype)[:, None] * oth)
    is_u = OC == 0
    out_x = Fx.at[PP[is_u], OI[is_u], OJ[is_u], :].set(mean[is_u])
    out_y = Fy.at[PP[~is_u], OI[~is_u], OJ[~is_u], :].set(mean[~is_u])
    return out_x, out_y


def cubed_sphere_corner_vorticity(zeta, u, v, grid):
    """Overwrite the 4 cube-corner points of a stacked (6,nx,ny,nz)
    vorticity field with the exact 3-segment circulation."""
    g = grid.panel_grid
    corners, comp_t, ii_t, jj_t, w_t, area_t = corner_circulation_tables(
        grid.N_panel, g.Hx)
    pp = np.arange(6)[:, None]
    for c, (ci, cj) in enumerate(corners):
        uu = u[pp, ii_t[c], jj_t[c], :]          # (6, 3, nz)
        vv = v[pp, ii_t[c], jj_t[c], :]
        vel = jnp.where(jnp.asarray(comp_t[c] == 0)[..., None], uu, vv)
        val = (vel * jnp.asarray(w_t[c])[..., None]).sum(axis=1) \
            / (jnp.asarray(area_t[c])[:, None] * g.radius)
        zeta = zeta.at[:, ci, cj, :].set(val.astype(zeta.dtype))
    return zeta


@lru_cache(None)
def _velocity_maps_flat(N: int, H: int):
    """The per-(panel, side, component) velocity maps concatenated into
    ONE flat table per destination component: 2 gathers + 1 scatter per
    component instead of ~48 small slice updates (smaller jaxprs, one
    gather for GSPMD to partition)."""
    maps = _velocity_maps(N, H)
    flat = {}
    for dst_comp in ("u", "v"):
        DP, DI, DJ, SQ, SI, SJ, SGN, ISU = ([] for _ in range(8))
        for (p, side, comp), (q, I, J, scomp, iq, jq, sgn) in maps.items():
            if comp != dst_comp:
                continue
            DP.append(np.full(I.size, p))
            DI.append(I)
            DJ.append(J)
            SQ.append(np.full(I.size, q))
            SI.append(iq)
            SJ.append(jq)
            SGN.append(sgn)
            ISU.append(scomp == "u")
        flat[dst_comp] = tuple(np.concatenate(v) for v in
                               (DP, DI, DJ, SQ, SI, SJ, SGN, ISU))
    return flat


def cubed_sphere_velocity_exchange(u, v, grid: ConformalCubedSphereGrid):
    """Fill the x/y halos of stacked (6, nx, ny, nz) u (x-face) and v
    (y-face) velocity components, applying the cross-edge component
    rotation (reference: the rotated connectivity of
    ``cubed_sphere_connectivity.jl`` applied to velocity fields)."""
    g = grid.panel_grid
    flat = _velocity_maps_flat(grid.N_panel, g.Hx)
    outs = {}
    for dst_comp, (DP, DI, DJ, SQ, SI, SJ, SGN, ISU) in flat.items():
        src_u = u[SQ, SI, SJ, :]
        src_v = v[SQ, SI, SJ, :]
        vals = jnp.where(jnp.asarray(ISU)[:, None], src_u, src_v)
        vals = vals * jnp.asarray(SGN, vals.dtype)[:, None]
        tgt = u if dst_comp == "u" else v
        outs[dst_comp] = tgt.at[DP, DI, DJ, :].set(vals)
    return outs["u"], outs["v"]


def _fill_halo_corners(a, H, N):
    """Fill the H×H corner halo blocks of a stacked (6, nx, ny, nz)
    field. Every panel corner is a 3-valent CUBE corner, so the corner
    halo region has no source panel — it is fictitious. Following the
    standard cubed-sphere practice, each corner cell is set to the
    average of its reflections into the two adjacent (already filled)
    edge-halo strips, giving a smooth O(Δx) extension that keeps the
    strip-edge interpolations (e.g. ℑy(h) feeding mass transports)
    finite and consistent."""
    lo, hi = slice(0, H), slice(H + N, 2 * H + N)
    rlo = slice(2 * H - 1, H - 1, -1)        # reflect across the low edge
    rhi = slice(H + N - 1, N - 1, -1)        # reflect across the high edge
    a = a.at[:, lo, lo].set(0.5 * (a[:, lo, rlo] + a[:, rlo, lo]))
    a = a.at[:, hi, lo].set(0.5 * (a[:, hi, rlo] + a[:, rhi, lo]))
    a = a.at[:, lo, hi].set(0.5 * (a[:, lo, rhi] + a[:, rlo, hi]))
    a = a.at[:, hi, hi].set(0.5 * (a[:, hi, rhi] + a[:, rhi, hi]))
    return a


def _exchange_maps(grid: ConformalCubedSphereGrid, H: int):
    """Flat (dst_p, dst_i, dst_j, src_p, src_i, src_j) index tables for
    the center-located inter-panel halo fill: the 6 panels × 4 sides ×
    H rings × N cells collapse into ONE advanced-indexing gather (far
    fewer ops than the per-(panel, side, ring) slice loop — smaller
    jaxprs, and a single gather for GSPMD to partition)."""
    cache = getattr(grid, "_exch_maps", None)
    if cache is None:
        cache = {}
        object.__setattr__(grid, "_exch_maps", cache)
    if H in cache:
        return cache[H]
    g = grid.panel_grid
    N = g.Nx
    Hx, Hy = g.Hx, g.Hy
    ks = np.arange(N)
    dst_p = []
    dst_i = []
    dst_j = []
    src_p = []
    src_i = []
    src_j = []
    for p in range(6):
        for side in _SIDES:
            q, r, rev = grid.connectivity[(p, side)]
            for h in range(H):
                # source line: interior cells ``h`` in from side ``r``
                # of panel ``q`` (index order along the edge)
                if r == "west":
                    si, sj = np.full(N, Hx + h), Hy + ks
                elif r == "east":
                    si, sj = np.full(N, Hx + N - 1 - h), Hy + ks
                elif r == "south":
                    si, sj = Hx + ks, np.full(N, Hy + h)
                else:
                    si, sj = Hx + ks, np.full(N, Hy + N - 1 - h)
                if rev:
                    si, sj = si[::-1], sj[::-1]
                if side == "west":
                    di, dj = np.full(N, Hx - 1 - h), Hy + ks
                elif side == "east":
                    di, dj = np.full(N, Hx + N + h), Hy + ks
                elif side == "south":
                    di, dj = Hx + ks, np.full(N, Hy - 1 - h)
                else:
                    di, dj = Hx + ks, np.full(N, Hy + N + h)
                dst_p.append(np.full(N, p))
                dst_i.append(di)
                dst_j.append(dj)
                src_p.append(np.full(N, q))
                src_i.append(si)
                src_j.append(sj)
    maps = tuple(np.concatenate(v) for v in
                 (dst_p, dst_i, dst_j, src_p, src_i, src_j))
    cache[H] = maps
    return maps


def cubed_sphere_halo_exchange(a, grid: ConformalCubedSphereGrid,
                               width=None, fill_corners=True):
    """Fill the x/y halos of a stacked (6, nx, ny, nz) CENTER-located
    field from the neighboring panels (reference
    ``multi_region_boundary_conditions.jl`` inter-region fill, with the
    cubed-sphere rotated connectivity) — one precomputed gather."""
    g = grid.panel_grid
    H = g.Hx if width is None else width
    N = g.Nx
    dp, di, dj, sp, si, sj = _exchange_maps(grid, H)
    out = a.at[dp, di, dj, :].set(a[sp, si, sj, :])
    if fill_corners:
        out = _fill_halo_corners(out, H, N)
    return out
