"""Explicit bounded-collectives distributed cubed sphere.

The GSPMD path (``cubed_sphere_partition`` + the flat gather exchanges of
``grids/cubed_sphere_grid.py``) lets the compiler partition the
inter-panel gathers; under a sub-panel partition (R > 1) that costs
all-gathers whose volume grows with R. This module is the explicit
mirror-rank path: the stacked (6, nx, ny, nz) state is re-laid-out into
per-device blocks that carry their OWN halo rings, and every inter-block
transfer — within-panel block halos, rotated inter-panel velocity/center
strips, and the edge-face flux synchronization — is precomputed into
per-device-pair index tables executed as a fixed number of
``jax.lax.ppermute`` rounds inside one ``shard_map``. Collectives per
step are bounded and independent of both the advection order and R, and
each moves O(edge strip) bytes instead of whole panels.

The per-pair content is derived numerically from the same validated
global tables the serial model uses (``_exchange_maps``,
``_velocity_maps_flat``, ``_edge_face_maps_flat``), so the distributed
step reproduces the serial step bitwise: every block window evolves
exactly like the corresponding window of the serial panel frame.

Reference: ``src/MultiRegion/cubed_sphere_partitions.jl:7-40`` (Rx·Ry
ranks per panel) + ``multi_region_boundary_conditions.jl`` (the
device-to-device rotated halo fill); the mechanism here is
mirror-rank ``ppermute`` over a ("panel", "x", "y") device mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from oceananigans_tpu.grids.cubed_sphere_grid import (
    ConformalCubedSphereGrid, _edge_face_maps_flat, _exchange_maps,
    _velocity_maps_flat, corner_circulation_tables,
)
from oceananigans_tpu.grids.base import Center as _Center
from oceananigans_tpu.grids.orthogonal import OrthogonalSphericalShellGrid
from oceananigans_tpu.ops.operators import (
    dx_c, dx_f, dy_c, dy_f, vorticity_z_ff,
)
from oceananigans_tpu.timesteppers import RK3_STAGES, tick

__all__ = ["CubedSphereDistributedSW", "CubedSphereDistributedHydrostatic"]

_AXES = ("panel", "x", "y")


# ---------------------------------------------------------------------------
# Block layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    N: int          # panel interior size
    H: int          # halo width
    R: int          # blocks per panel dimension
    panels: int     # ways the panel axis is split (divides 6)
    nloc: int       # block interior size (N // R)
    nl2: int        # block frame size (nloc + 2H)
    P_loc: int      # panels per device (6 // panels)
    n_dev: int

    def dev(self, p, bx, by):
        pg = p // self.P_loc
        return (pg * self.R + bx) * self.R + by

    def cell(self, p, li, lj):
        """Flat cell index within one field's per-device block stack."""
        pl = p % self.P_loc
        return (pl * self.nl2 + li) * self.nl2 + lj

    @property
    def cells(self):
        """Cells per field per device."""
        return self.P_loc * self.nl2 * self.nl2

    def locate(self, p, gi, gj, face_x=False, face_y=False):
        """(device, local i, local j) owning panel-frame cell (gi, gj).

        ``face_x``/``face_y``: the coordinate is face-located along that
        axis, so the shared panel-edge slot at H + N clips to the last
        block (within-panel shared faces resolve to the right/up block;
        either side holds the identical value)."""
        H, nloc, R = self.H, self.nloc, self.R
        bx = (gi - H) // nloc
        if face_x:
            bx = min(bx, R - 1)
        by = (gj - H) // nloc
        if face_y:
            by = min(by, R - 1)
        li = gi - bx * nloc
        lj = gj - by * nloc
        return self.dev(p, bx, by), self.cell(p, li, lj)


# ---------------------------------------------------------------------------
# Pair-exchange machinery: entries -> ppermute rounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Round:
    perm: tuple | None       # ppermute permutation; None = device-local
    src: np.ndarray          # (n_dev, L) flat gather indices
    sgn: np.ndarray          # (n_dev, L) signs (0 at padding)
    dst: np.ndarray          # (n_dev, L) flat scatter indices (pad -> M)


@dataclasses.dataclass(frozen=True)
class _Exchange:
    rounds: tuple            # local round first (perm None), then ppermutes
    n_fields: int


def _build_exchange(entries, lay: _Layout, n_fields):
    """``entries``: list of (dst_dev, dst_flat, src_dev, src_flat, sgn)
    with field offsets already folded into the flat indices."""
    M = lay.cells * n_fields
    pairs = {}
    for dd, df, sd, sf, sg in entries:
        pairs.setdefault((sd, dd), []).append((df, sf, sg))

    local = {k: v for k, v in pairs.items() if k[0] == k[1]}
    remote = {k: v for k, v in pairs.items() if k[0] != k[1]}

    # greedy round coloring: per round each device sends <= 1 buffer and
    # receives <= 1 buffer (a valid ppermute permutation)
    colored = []     # list of dict (s, d) -> entry list
    for key in sorted(remote):
        ent = remote[key]
        s, d = key
        for r in colored:
            if all(ps != s for ps, pd in r) and \
                    all(pd != d for ps, pd in r):
                r[key] = ent
                break
        else:
            colored.append({key: ent})

    def tables(groups, by_sender_dst):
        L = max(len(v) for v in groups.values())
        src = np.zeros((lay.n_dev, L), np.int32)
        sgn = np.zeros((lay.n_dev, L))
        dst = np.full((lay.n_dev, L), M, np.int32)
        for (s, d), ent in groups.items():
            n = len(ent)
            src[s, :n] = [e[1] for e in ent]
            sgn[s, :n] = [e[2] for e in ent]
            dst[d, :n] = [e[0] for e in ent]
        return src, sgn, dst

    rounds = []
    if local:
        rounds.append(_Round(None, *tables(local, True)))
    for r in colored:
        perm = tuple((s, d) for (s, d) in r)
        rounds.append(_Round(perm, *tables(r, True)))
    return _Exchange(tuple(rounds), n_fields)


def _apply_exchange(ex: _Exchange, arrays, dev, mean=False):
    """Run the exchange on a list of same-shaped (P_loc, nl2, nl2, nz)
    arrays. ``mean``: received values are averaged with the PRE-exchange
    destination values (the edge-face flux synchronization) instead of
    overwriting them."""
    nz = arrays[0].shape[-1]
    flat = jnp.concatenate([a.reshape(-1, nz) for a in arrays], axis=0)
    padded = jnp.concatenate(
        [flat, jnp.zeros((1, nz), flat.dtype)], axis=0)
    out = padded
    for r in ex.rounds:
        src = jnp.take(r.src, dev, axis=0)
        sgn = jnp.take(r.sgn, dev, axis=0).astype(flat.dtype)
        buf = jnp.take(flat, src, axis=0) * sgn[:, None]
        if r.perm is not None:
            buf = jax.lax.ppermute(buf, _AXES, r.perm)
        d = jnp.take(r.dst, dev, axis=0)
        if mean:
            own = jnp.take(padded, d, axis=0)
            out = out.at[d].set(0.5 * (own + buf))
        else:
            out = out.at[d].set(buf)
    out = out[:-1]
    c = arrays[0].size // nz
    return [out[i * c:(i + 1) * c].reshape(arrays[0].shape)
            for i in range(len(arrays))]


# ---------------------------------------------------------------------------
# Entry derivation from the serial global tables
# ---------------------------------------------------------------------------

def _state_fill_entries(grid, lay: _Layout, n_center,
                        with_velocity=True):
    """Entries for the merged state fill: fields [u, v, c0, c1, ...]
    (velocity rotation tables + center tables + within-panel copies).
    ``with_velocity=False``: center fields only, offsets from 0."""
    N, H, nloc, nl2 = lay.N, lay.H, lay.nloc, lay.nl2
    C = lay.cells
    coff = 2 * C if with_velocity else 0

    dp, di, dj, sp, si, sj = _exchange_maps(grid, H)
    cdict = {}
    for k in range(dp.size):
        cdict[(int(dp[k]), int(di[k]), int(dj[k]))] = (
            int(sp[k]), int(si[k]), int(sj[k]))

    vdict = {}
    if with_velocity:
        for comp, (DP, DI, DJ, SQ, SI, SJ, SGN, ISU) in \
                _velocity_maps_flat(N, H).items():
            for k in range(DP.size):
                vdict[(comp, int(DP[k]), int(DI[k]), int(DJ[k]))] = (
                    int(SQ[k]), int(SI[k]), int(SJ[k]), float(SGN[k]),
                    bool(ISU[k]))

    entries = []
    for p in range(6):
        for bx in range(lay.R):
            for by in range(lay.R):
                ddev = lay.dev(p, bx, by)
                for li in range(nl2):
                    gi = bx * nloc + li
                    for lj in range(nl2):
                        gj = by * nloc + lj
                        dflat = lay.cell(p, li, lj)
                        # --- u (field 0) and v (field 1): each field's
                        # owned region includes its shared block face
                        for f, comp in (((0, "u"), (1, "v"))
                                        if with_velocity else ()):
                            iu = comp == "u"
                            if (H <= li < H + nloc + iu
                                    and H <= lj < H + nloc + (not iu)):
                                continue        # owned locally
                            hit = vdict.get((comp, p, gi, gj))
                            if hit is not None:
                                q, sgi, sgj, sg, isu = hit
                                sdev, sflat = lay.locate(
                                    q, sgi, sgj, face_x=isu,
                                    face_y=not isu)
                                entries.append(
                                    (ddev, f * C + dflat, sdev,
                                     (0 if isu else 1) * C + sflat, sg))
                            elif (H <= gi < H + N + iu
                                    and H <= gj < H + N + (not iu)):
                                sdev, sflat = lay.locate(
                                    p, gi, gj, face_x=iu, face_y=not iu)
                                entries.append(
                                    (ddev, f * C + dflat, sdev,
                                     f * C + sflat, 1.0))
                            # else: panel-corner wedge — stale in the
                            # serial frame too (never read)
                        # --- center fields (shared tables)
                        if H <= li < H + nloc and H <= lj < H + nloc:
                            continue
                        hit = cdict.get((p, gi, gj))
                        if hit is not None:
                            q, sgi, sgj = hit
                            sdev, sflat = lay.locate(q, sgi, sgj)
                            for f in range(n_center):
                                off = coff + f * C
                                entries.append((ddev, off + dflat, sdev,
                                                off + sflat, 1.0))
                        elif H <= gi < H + N and H <= gj < H + N:
                            sdev, sflat = lay.locate(p, gi, gj)
                            for f in range(n_center):
                                off = coff + f * C
                                entries.append((ddev, off + dflat, sdev,
                                                off + sflat, 1.0))
                        # else: panel-corner wedge — filled by the local
                        # reflection averaging (cube corners)
    return entries


def _flux_sync_entries(lay: _Layout, n_pairs):
    """Entries for the edge-face flux synchronization over flux pairs
    [Fx0, Fy0, Fx1, Fy1, ...] (mean mode: both sides replace their edge
    value by the rotation-consistent mean)."""
    PP, OC, OI, OJ, QQ, NC, NI, NJ, SG = _edge_face_maps_flat(lay.N,
                                                              lay.H)
    C = lay.cells
    entries = []
    for k in range(PP.size):
        oc = int(OC[k])
        ddev, dflat = lay.locate(int(PP[k]), int(OI[k]), int(OJ[k]),
                                 face_x=oc == 0, face_y=oc == 1)
        nc = int(NC[k])
        sdev, sflat = lay.locate(int(QQ[k]), int(NI[k]), int(NJ[k]),
                                 face_x=nc == 0, face_y=nc == 1)
        for f in range(n_pairs):
            entries.append((ddev, (2 * f + oc) * C + dflat,
                            sdev, (2 * f + nc) * C + sflat,
                            float(SG[k])))
    return entries


# ---------------------------------------------------------------------------
# Local (per-device) corner operators
# ---------------------------------------------------------------------------

def _corner_tap_tables(grid, lay: _Layout):
    """Per-device cube-corner circulation tables in block-local indices
    (the serial ``cubed_sphere_corner_vorticity`` gathers, localized to
    the panel-corner blocks that own the corner vorticity points)."""
    corners, comp_t, ii_t, jj_t, w_t, area_t = corner_circulation_tables(
        lay.N, lay.H)
    H, N, R, nloc, nl2 = lay.H, lay.N, lay.R, lay.nloc, lay.nl2
    nd, PL = lay.n_dev, lay.P_loc
    block_of = {(H, H): (0, 0), (H + N, H): (R - 1, 0),
                (H, H + N): (0, R - 1), (H + N, H + N): (R - 1, R - 1)}
    T = np.shape(comp_t[0])[1]      # taps per corner (2 per leg)
    FLAG = np.zeros((nd, PL, 4))
    CI = np.zeros((nd, PL, 4), np.int32)
    CJ = np.zeros((nd, PL, 4), np.int32)
    TC = np.zeros((nd, PL, 4, T), np.int32)
    TI = np.zeros((nd, PL, 4, T), np.int32)
    TJ = np.zeros((nd, PL, 4, T), np.int32)
    TW = np.zeros((nd, PL, 4, T))
    TA = np.ones((nd, PL, 4))
    for c, (ci, cj) in enumerate(corners):
        bx, by = block_of[(ci, cj)]
        for p in range(6):
            dev = lay.dev(p, bx, by)
            pl = p % PL
            FLAG[dev, pl, c] = 1.0
            CI[dev, pl, c] = ci - bx * nloc
            CJ[dev, pl, c] = cj - by * nloc
            ti = np.asarray(ii_t[c][p]) - bx * nloc
            tj = np.asarray(jj_t[c][p]) - by * nloc
            if ti.min() < 0 or ti.max() >= nl2 or tj.min() < 0 \
                    or tj.max() >= nl2:
                raise ValueError(
                    "cube-corner circulation taps leave the block "
                    f"window (block {nloc}, halo {H}); use a larger "
                    "block or halo")
            TC[dev, pl, c] = comp_t[c][p]
            TI[dev, pl, c] = ti
            TJ[dev, pl, c] = tj
            TW[dev, pl, c] = w_t[c][p]
            TA[dev, pl, c] = area_t[c][p]
    return FLAG, CI, CJ, TC, TI, TJ, TW, TA


def _corner_avg_flags(lay: _Layout):
    """(n_dev, 4) flags: which of the 4 local frame corners of each
    device's blocks are PANEL corners (cube corners) needing the local
    reflection averaging. Order: SW, NW (y-high), SE (x-high), NE."""
    F = np.zeros((lay.n_dev, 4))
    R = lay.R
    for p in range(6):
        for bx in range(R):
            for by in range(R):
                dev = lay.dev(p, bx, by)
                F[dev, 0] = bx == 0 and by == 0
                F[dev, 1] = bx == 0 and by == R - 1
                F[dev, 2] = bx == R - 1 and by == 0
                F[dev, 3] = bx == R - 1 and by == R - 1
    return F


# ---------------------------------------------------------------------------
# The distributed model
# ---------------------------------------------------------------------------

class _CSDistBase:
    """Shared machinery of the explicit-halo distributed cubed-sphere
    models: block layout + mesh, layout conversions, block-windowed
    grid/metric leaves, and the per-device corner table ops.

    Usage (both subclasses)::

        dm = CubedSphereDistributed*(model, R=2, panels=2)  # 8 devices
        bstate = dm.to_local_state(state)                   # once
        bstate = dm.step(bstate, dt)                        # jitted
        state = dm.from_local_state(bstate)

    The step matches the serial model bitwise: each device's block
    window evolves exactly like the same window of the serial panel
    frame (the exchanges reproduce the serial gather fills, the corner
    reflection averaging and cube-corner circulation run as per-device
    local table ops).
    """

    def __init__(self, model, R=1, panels=6, devices=None):
        grid = model.grid
        g = grid.panel_grid
        N, H = grid.N_panel, g.Hx
        if g.Hx != g.Hy:
            raise ValueError("anisotropic halos unsupported")
        if 6 % panels:
            raise ValueError(f"panels={panels} must divide 6")
        if N % R:
            raise ValueError(f"panel size {N} must divide R={R}")
        nloc = N // R
        if nloc <= H:
            raise ValueError(f"block interior {nloc} must exceed the "
                             f"halo width {H}")
        need = panels * R * R
        if devices is None:
            devices = jax.devices()[:need]
        if len(devices) != need:
            raise ValueError(f"needs {need} devices, got {len(devices)}")
        self.model = model
        self.grid = grid
        self.lay = _Layout(N=N, H=H, R=R, panels=panels, nloc=nloc,
                           nl2=nloc + 2 * H, P_loc=6 // panels,
                           n_dev=need)
        self.mesh = Mesh(np.array(devices).reshape(panels, R, R), _AXES)
        self._state_sharding = NamedSharding(self.mesh,
                                             P("panel", "x", "y", None))

        self.corner_taps = _corner_tap_tables(grid, self.lay)
        self.avg_flags = _corner_avg_flags(self.lay)

        # block-windowed grid data (same window for every panel: the
        # conformal panels are congruent) and per-panel constants
        self._grid_fields_2d = {}
        self._grid_fields_z = {}
        for f in OrthogonalSphericalShellGrid._data_fields:
            a = getattr(g, f)
            if a.shape[0] == N + 2 * H and a.shape[1] == N + 2 * H:
                self._grid_fields_2d[f] = self._block_tile_2d(a)
            else:
                self._grid_fields_z[f] = a
        self.f_blocked = jax.device_put(
            self._block_panel(jnp.asarray(model.f_ff)),
            self._state_sharding)
        self.cm_blocked = self._block_tile_2d(
            jnp.asarray(model._corner_mask))
        self.cmke_blocked = self._block_tile_2d(
            jnp.asarray(getattr(model, "_corner_mask_ke",
                                model._corner_mask)))
        # block-local interior masks (device-independent: every block
        # owns its interior, face fields include the shared high face —
        # within-panel shared faces are computed identically on both
        # sides, the panel-edge face is the serial interior-owned slot)
        nl2 = self.lay.nl2
        mc = np.zeros((nl2, nl2, 1))
        mc[H:H + nloc, H:H + nloc] = 1.0
        mu = np.zeros((nl2, nl2, 1))
        mu[H:H + nloc + 1, H:H + nloc] = 1.0
        mv = np.zeros((nl2, nl2, 1))
        mv[H:H + nloc, H:H + nloc + 1] = 1.0
        self._lmasks = (mu, mv, mc)
        self._pstep = None

    # ---- layout conversions ---------------------------------------------
    def _block_tile_2d(self, a):
        """(nx, ny, 1) panel-frame array -> (R·nl2, R·nl2, 1) tiling of
        the per-block overlap windows, sharded over ("x", "y")."""
        lay = self.lay
        rows = []
        for bx in range(lay.R):
            row = [a[bx * lay.nloc:bx * lay.nloc + lay.nl2,
                     by * lay.nloc:by * lay.nloc + lay.nl2]
                   for by in range(lay.R)]
            rows.append(jnp.concatenate(row, axis=1))
        out = jnp.concatenate(rows, axis=0)
        return jax.device_put(out, NamedSharding(self.mesh,
                                                 P("x", "y", None)))

    def _block_panel(self, a):
        """(6, nx, ny, nz) stacked array -> blocked overlap layout
        (6, R·nl2, R·nl2, nz)."""
        lay = self.lay
        rows = []
        for bx in range(lay.R):
            row = [a[:, bx * lay.nloc:bx * lay.nloc + lay.nl2,
                     by * lay.nloc:by * lay.nloc + lay.nl2]
                   for by in range(lay.R)]
            rows.append(jnp.concatenate(row, axis=2))
        return jnp.concatenate(rows, axis=1)

    def _unblock_panel(self, a):
        """Blocked layout -> stacked panel frame: block interiors, plus
        the panel halo ring taken from the edge blocks' windows."""
        lay = self.lay
        N, H, nloc, nl2 = lay.N, lay.H, lay.nloc, lay.nl2
        out = np.zeros((6, N + 2 * H, N + 2 * H) + a.shape[3:], a.dtype)
        a = np.asarray(a)
        for bx in range(lay.R):
            x0, x1 = (0, nl2) if lay.R == 1 else (
                (0, H + nloc) if bx == 0 else
                (H, nl2) if bx == lay.R - 1 else (H, H + nloc))
            for by in range(lay.R):
                y0, y1 = (0, nl2) if lay.R == 1 else (
                    (0, H + nloc) if by == 0 else
                    (H, nl2) if by == lay.R - 1 else (H, H + nloc))
                blk = a[:, bx * nl2:(bx + 1) * nl2,
                        by * nl2:(by + 1) * nl2]
                out[:, bx * nloc + x0:bx * nloc + x1,
                    by * nloc + y0:by * nloc + y1] = blk[:, x0:x1, y0:y1]
        return jnp.asarray(out)

    def to_local_state(self, state):
        def go(leaf):
            if getattr(leaf, "ndim", 0) == 4 and leaf.shape[0] == 6:
                return jax.device_put(self._block_panel(leaf),
                                      self._state_sharding)
            return leaf
        return jax.tree_util.tree_map(go, state)

    def from_local_state(self, bstate):
        def go(leaf):
            if getattr(leaf, "ndim", 0) == 4 and leaf.shape[0] == 6:
                return self._unblock_panel(leaf)
            return leaf
        return jax.tree_util.tree_map(go, bstate)

    def initial_state(self, **kw):
        return self.to_local_state(self.model.initial_state(**kw))

    # ---- the step ---------------------------------------------------------
    def _local_grid(self, fields2d):
        g = self.grid.panel_grid
        obj = object.__new__(OrthogonalSphericalShellGrid)
        for f in OrthogonalSphericalShellGrid._meta_fields:
            object.__setattr__(obj, f, getattr(g, f))
        object.__setattr__(obj, "Nx", self.lay.nloc)
        object.__setattr__(obj, "Ny", self.lay.nloc)
        for f, v in self._grid_fields_z.items():
            object.__setattr__(obj, f, v)
        for f, v in fields2d.items():
            object.__setattr__(obj, f, v)
        return obj

    def _corner_fix(self, zeta, u, v, dev):
        FLAG, CI, CJ, TC, TI, TJ, TW, TA = self.corner_taps
        radius = self.grid.panel_grid.radius
        flag = jnp.take(FLAG, dev, axis=0)
        ci = jnp.take(CI, dev, axis=0)
        cj = jnp.take(CJ, dev, axis=0)
        tc = jnp.take(TC, dev, axis=0)
        ti = jnp.take(TI, dev, axis=0)
        tj = jnp.take(TJ, dev, axis=0)
        tw = jnp.take(TW, dev, axis=0).astype(u.dtype)
        ta = jnp.take(TA, dev, axis=0).astype(u.dtype)
        pl3 = jnp.arange(self.lay.P_loc)[:, None, None]
        uu = u[pl3, ti, tj, :]                       # (P_loc, 4, 3, nz)
        vv = v[pl3, ti, tj, :]
        vel = jnp.where((tc == 0)[..., None], uu, vv)
        val = (vel * tw[..., None]).sum(axis=2) / (ta[..., None] * radius)
        pl2 = jnp.arange(self.lay.P_loc)[:, None]
        cur = zeta[pl2, ci, cj, :]
        new = jnp.where((flag > 0)[..., None], val.astype(zeta.dtype),
                        cur)
        return zeta.at[pl2, ci, cj, :].set(new)

    def _corner_avg(self, a, dev):
        """The serial ``_fill_halo_corners`` reflection averaging,
        applied only at this device's panel-corner frames."""
        lay = self.lay
        H, nloc = lay.H, lay.nloc
        fl = jnp.take(self.avg_flags, dev, axis=0)
        lo, hi = slice(0, H), slice(H + nloc, 2 * H + nloc)
        rlo = slice(2 * H - 1, H - 1, -1)
        rhi = slice(H + nloc - 1, nloc - 1, -1)

        def upd(a, s1, s2, r1, r2, f):
            avg = 0.5 * (a[:, s1, r2] + a[:, r1, s2])
            return a.at[:, s1, s2].set(jnp.where(f > 0, avg, a[:, s1, s2]))

        a = upd(a, lo, lo, rlo, rlo, fl[0])
        a = upd(a, lo, hi, rlo, rhi, fl[1])
        a = upd(a, hi, lo, rhi, rlo, fl[2])
        a = upd(a, hi, hi, rhi, rhi, fl[3])
        return a

    def step(self, state, dt):
        if self._pstep is None:
            self._pstep = self._build()
        return self._pstep(state, dt)

    def __repr__(self):
        lay = self.lay
        return (f"{type(self).__name__}(N={lay.N}, R={lay.R}, "
                f"panels={lay.panels}, devices={lay.n_dev})")


def _block_cf_aux(wrapper, model):
    """Blocked corner-filter weights for a distributed wrapper (empty
    dict when the filter is off). The serial weights are panel-frame
    (``_corner_filter_setup``); blocking carries each block's halo ring
    so the flux-form taps agree across block boundaries."""
    if not getattr(model, "corner_filter", None):
        return {}
    out = {}
    for nm in ("_cf_x", "_cf_y", "_cf_inv_az"):
        a = np.asarray(getattr(model, nm))
        if a.ndim == 3:
            a = np.broadcast_to(a, (6,) + a.shape)
        out[nm] = jax.device_put(
            wrapper._block_panel(jnp.asarray(a)),
            wrapper._state_sharding)
    return out


def _corner_filter_fns(model, cfa, cm, dtype):
    """(smooth_center, smooth_vel) replicating the serial corner-band
    filter (``_corner_smooth_center`` / ``_corner_smooth_velocity``) on
    the blocked local layout: identical taps (the one-ring Laplacian
    reads freshly exchanged halo values), so the distributed filter is
    bitwise the serial one at interior cells."""
    cfx = jnp.asarray(cfa["_cf_x"], dtype)
    cfy = jnp.asarray(cfa["_cf_y"], dtype)
    ia = jnp.asarray(cfa["_cf_inv_az"], dtype)
    eps = float(model.corner_filter)
    cml = jnp.asarray(cm, dtype)

    def smooth_center(q):
        wx, wy = cfx, cfy
        if q.shape[-1] != wx.shape[-1]:
            wx = jnp.max(wx, axis=-1, keepdims=True)
            wy = jnp.max(wy, axis=-1, keepdims=True)

        def panel(a, ax, ay, ii):
            return a + (dx_c(ax * dx_f(a)) + dy_c(ay * dy_f(a))) * ii
        return jax.vmap(panel)(q, wx, wy, ia)

    def smooth_vel(q, mask):
        def panel(a):
            lap = (jnp.roll(a, 1, 0) + jnp.roll(a, -1, 0)
                   + jnp.roll(a, 1, 1) + jnp.roll(a, -1, 1) - 4.0 * a)
            return a + eps * cml * lap
        return q + (jax.vmap(panel)(q) - q) * jnp.asarray(mask, dtype)

    return smooth_center, smooth_vel


class CubedSphereDistributedSW(_CSDistBase):
    """Explicit-halo distributed ``CubedSphereShallowWaterModel``
    (see ``_CSDistBase`` for the usage pattern and guarantees)."""

    def __init__(self, model, R=1, panels=6, devices=None):
        from oceananigans_tpu.models.cubed_sphere import (
            CubedSphereShallowWaterModel,
        )
        if not isinstance(model, CubedSphereShallowWaterModel):
            raise ValueError("CubedSphereDistributedSW wraps a "
                             "CubedSphereShallowWaterModel")
        super().__init__(model, R=R, panels=panels, devices=devices)
        self.cf_aux = _block_cf_aux(self, model)
        self.vfix_blocked = self._block_tile_2d(jnp.asarray(model._vfix))
        names = model.tracer_names
        self.ex_state = _build_exchange(
            _state_fill_entries(self.grid, self.lay, 1 + len(names)),
            self.lay, 3 + len(names))
        self.ex_flux = _build_exchange(
            _flux_sync_entries(self.lay, 1 + len(names)),
            self.lay, 2 * (1 + len(names)))
        self.hs_blocked = None if model.hs is None else jax.device_put(
            self._block_panel(model.hs), self._state_sharding)

    def _build(self):
        from oceananigans_tpu.models.cubed_sphere import (
            CubedSphereShallowWaterModel as SW,
        )
        model, lay, mesh = self.model, self.lay, self.mesh
        names = model.tracer_names
        mu_l, mv_l, mc_l = self._lmasks
        fields2d = self._grid_fields_2d
        R = lay.R

        def state_specs(state):
            return jax.tree_util.tree_map(
                lambda leaf: P("panel", "x", "y", None)
                if getattr(leaf, "ndim", 0) == 4 else P(), state)

        g2d_specs = {k: P("x", "y", None) for k in fields2d}
        has_hs = self.hs_blocked is not None

        def sstep(state, dt, g2d, fff, hs, cm, cfa, vfx, cmke):
            dev = (jax.lax.axis_index("panel") * R
                   + jax.lax.axis_index("x")) * R \
                + jax.lax.axis_index("y")
            lg = self._local_grid(g2d)
            view = SimpleNamespace(
                grid=SimpleNamespace(panel_grid=lg), g=model.g,
                vorticity_scheme=model.vorticity_scheme,
                tracer_advection=model.tracer_advection,
                _corner_mask=cm, _vfix=vfx,
                _corner_mask_ke=cmke)
            mu = jnp.asarray(mu_l, state.u.dtype)
            mv = jnp.asarray(mv_l, state.u.dtype)
            mc = jnp.asarray(mc_l, state.u.dtype)

            def fill(u, v, h, tracers):
                arrays = [u, v, h] + [tracers[n] for n in names]
                res = _apply_exchange(self.ex_state, arrays, dev)
                u, v = res[0], res[1]
                h = self._corner_avg(res[2], dev)
                tr = {n: self._corner_avg(res[3 + i], dev)
                      for i, n in enumerate(names)}
                return u, v, h, tr

            def tendencies(u, v, h, tracers):
                zeta = jax.vmap(
                    lambda up, vp: vorticity_z_ff(lg, up, vp))(u, v)
                zeta = self._corner_fix(zeta, u, v, dev)
                if has_hs:
                    Gu, Gv = jax.vmap(
                        partial(SW._panel_tendencies, view))(
                        u, v, h, fff, zeta, tracers, hs)
                else:
                    Gu, Gv = jax.vmap(
                        partial(SW._panel_tendencies, view))(
                        u, v, h, fff, zeta, tracers)
                Fx, Fy, Ft = jax.vmap(partial(SW._panel_fluxes, view))(
                    u, v, h, tracers)
                arrays = [Fx, Fy]
                for n in names:
                    arrays += [Ft[n][0], Ft[n][1]]
                res = _apply_exchange(self.ex_flux, arrays, dev,
                                      mean=True)
                Fx, Fy = res[0], res[1]
                Ftd = {n: (res[2 + 2 * i], res[3 + 2 * i])
                       for i, n in enumerate(names)}
                Gh, Gt = jax.vmap(
                    partial(SW._panel_flux_divergence, view))(
                    Fx, Fy, {n: tuple(f) for n, f in Ftd.items()})
                if model.prescribed_velocities:
                    Gu = jnp.zeros_like(Gu)
                    Gv = jnp.zeros_like(Gv)
                    Gh = jnp.zeros_like(Gh)
                else:
                    Gu = Gu * mu
                    Gv = Gv * mv
                    Gh = Gh * mc
                Gt = {n: G * mc for n, G in Gt.items()}
                return Gu, Gv, Gh, Gt

            dt_ = jnp.asarray(dt, state.h.dtype)
            G_prev = (state.Gu, state.Gv, state.Gh, state.Gtracers)
            u, v, h, tr = state.u, state.v, state.h, state.tracers
            for gamma, zeta_c in RK3_STAGES:
                u, v, h, tr = fill(u, v, h, tr)
                Gu, Gv, Gh, Gt = tendencies(u, v, h, tr)
                u = u + dt_ * (gamma * Gu + zeta_c * G_prev[0])
                v = v + dt_ * (gamma * Gv + zeta_c * G_prev[1])
                h = h + dt_ * (gamma * Gh + zeta_c * G_prev[2])
                tr = {n: tr[n] + dt_ * (gamma * Gt[n]
                                        + zeta_c * G_prev[3][n])
                      for n in names}
                G_prev = (Gu, Gv, Gh, Gt)
            u, v, h, tr = fill(u, v, h, tr)
            if cfa and not model.prescribed_velocities:
                # corner-band filter on FILLED halos (the serial
                # step's _apply_corner_filter sequence), then re-fill
                smooth_c, smooth_v = _corner_filter_fns(
                    model, cfa, cm, u.dtype)
                u = smooth_v(u, mu)
                v = smooth_v(v, mv)
                h = smooth_c(h)
                u, v, h, tr = fill(u, v, h, tr)
            return dataclasses.replace(
                state, u=u, v=v, h=h, tracers=tr,
                Gu=G_prev[0], Gv=G_prev[1], Gh=G_prev[2],
                Gtracers=G_prev[3], clock=tick(state.clock, dt_))

        def step(state, dt):
            specs = state_specs(state)
            hs = self.hs_blocked
            cf_specs = {k: P("panel", "x", "y", None)
                        for k in self.cf_aux}
            fn = shard_map(
                sstep, mesh=mesh,
                in_specs=(specs, P(), g2d_specs,
                          P("panel", "x", "y", None),
                          P("panel", "x", "y", None) if has_hs else P(),
                          P("x", "y", None), cf_specs,
                          P("x", "y", None), P("x", "y", None)),
                out_specs=specs, check_vma=False)
            return fn(state, dt, fields2d, self.f_blocked,
                      hs if has_hs else jnp.zeros(()), self.cm_blocked,
                      self.cf_aux, self.vfix_blocked, self.cmke_blocked)

        return jax.jit(step)


class CubedSphereDistributedHydrostatic(_CSDistBase):
    """Explicit-halo distributed ``CubedSphereHydrostaticModel`` (see
    ``_CSDistBase`` for the usage pattern and guarantees). The 3-D
    state (u, v, tracers at nz; eta at 1 level) exchanges in two
    round-sets per fill; w/pressure integrals, closures (including
    vertically-implicit column solves), and forcings run block-local."""

    def __init__(self, model, R=1, panels=6, devices=None):
        from oceananigans_tpu.models.cubed_sphere import (
            CubedSphereHydrostaticModel,
        )
        if not isinstance(model, CubedSphereHydrostaticModel):
            raise ValueError("CubedSphereDistributedHydrostatic wraps a "
                             "CubedSphereHydrostaticModel")
        super().__init__(model, R=R, panels=panels, devices=devices)
        names = model.tracer_names
        T = len(names)
        self.ex_uvtr = _build_exchange(
            _state_fill_entries(self.grid, self.lay, T), self.lay, 2 + T)
        self.ex_eta = _build_exchange(
            _state_fill_entries(self.grid, self.lay, 1,
                                with_velocity=False), self.lay, 1)
        self.ex_flux2d = _build_exchange(
            _flux_sync_entries(self.lay, 1), self.lay, 2)
        self.ex_fluxtr = _build_exchange(
            _flux_sync_entries(self.lay, T), self.lay, 2 * T) if T \
            else None
        if model.forcings:
            self.lam_blocked = jax.device_put(
                self._block_panel(jnp.asarray(model._lam_full)),
                self._state_sharding)
            self.phi_blocked = jax.device_put(
                self._block_panel(jnp.asarray(model._phi_full)),
                self._state_sharding)
        else:
            self.lam_blocked = self.phi_blocked = None
        # blocked auxiliary fields for bathymetry / flux BCs / momentum
        # forcing (each (6, R·nl2, R·nl2, ·), state-sharded)
        aux = {}
        if getattr(model, "_wet_u", None) is not None:
            for nm in ("_wet_c", "_wet_u", "_wet_v", "_wet_w",
                       "_Hc", "_Hu", "_Hv",
                       "_wet2_c", "_wet2_u", "_wet2_v",
                       "_top_c", "_top_u", "_top_v",
                       "_bot_c", "_bot_u", "_bot_v"):
                aux[nm] = jax.device_put(
                    self._block_panel(jnp.asarray(getattr(model, nm))),
                    self._state_sharding)
        if getattr(model, "_frac_c", None) is not None:
            # partial bottom cells: blocked height fractions
            for nm in ("_frac_c", "_frac_u", "_frac_v"):
                aux[nm] = jax.device_put(
                    self._block_panel(jnp.asarray(getattr(model, nm))),
                    self._state_sharding)
        needs_geo = bool(getattr(model, "bcs", None)) \
            or "u" in model.forcings or "v" in model.forcings
        if needs_geo:
            for nm in ("_lam_c", "_phi_c", "_lam_u", "_phi_u",
                       "_lam_v", "_phi_v"):
                aux[nm] = jax.device_put(
                    self._block_panel(jnp.asarray(getattr(model, nm))),
                    self._state_sharding)
        aux.update(_block_cf_aux(self, model))
        self.hy_aux = aux

    def _build(self):
        from oceananigans_tpu.models.cubed_sphere import (
            CubedSphereHydrostaticModel as HY,
        )
        from oceananigans_tpu import closures as closures_mod
        model, lay, mesh = self.model, self.lay, self.mesh
        names = model.tracer_names
        mu_l, mv_l, mc_l = self._lmasks
        fields2d = self._grid_fields_2d
        R = lay.R
        gf = self.grid.panel_grid
        Hz, Nz = gf.Hz, gf.Nz
        kk = np.arange(gf.shape[2])
        kin_np = ((kk >= Hz) & (kk < Hz + Nz)).astype(
            float).reshape(1, 1, 1, -1)
        implicit = model.closure is not None and \
            closures_mod.closure_is_vertically_implicit(model.closure)
        has_forcing = bool(model.forcings)

        def state_specs(state):
            return jax.tree_util.tree_map(
                lambda leaf: P("panel", "x", "y", None)
                if getattr(leaf, "ndim", 0) == 4 else P(), state)

        g2d_specs = {k: P("x", "y", None) for k in fields2d}

        def fill_z(a):
            if Hz == 0 or a.shape[-1] == 1:
                return a
            a = a.at[..., Hz - 1].set(a[..., Hz])
            return a.at[..., Hz + Nz].set(a[..., Hz + Nz - 1])

        has_bath = getattr(model, "_wet_u", None) is not None
        has_bcs = bool(getattr(model, "bcs", None))
        prescribed = bool(getattr(model, "prescribed_velocities", False))
        zstar = getattr(model, "_zstar", False)

        def sstep(state, dt, g2d, fff, cm, lam, phi, aux, cmke):
            dev = (jax.lax.axis_index("panel") * R
                   + jax.lax.axis_index("x")) * R \
                + jax.lax.axis_index("y")
            lg = self._local_grid(g2d)
            view = SimpleNamespace(
                grid=SimpleNamespace(panel_grid=lg,
                                     N_panel=model.grid.N_panel),
                g=model.g,
                tracer_advection=model.tracer_advection,
                _corner_mask=cm,
                buoyancy=getattr(model, "buoyancy", None),
                momentum_advection=getattr(model, "momentum_advection",
                                           None),
                bcs=getattr(model, "bcs", {}),
                _dz_row=getattr(model, "_dz_row", None),
                _explicit_eta_grad=getattr(model, "_explicit_eta_grad",
                                           True),
                _corner_mask_ke=cmke)
            view._panel_w = lambda uu, vv, gg=None, wc=None: HY._panel_w(
                view, uu, vv, gg, wc)
            view._panel_pressure = lambda bb, gg=None: HY._panel_pressure(
                view, bb, gg)
            view._buoyancy_ccc = lambda gg, tr: HY._buoyancy_ccc(view, gg,
                                                                 tr)
            # blocked boundary-cell indicators (bathymetry) or the
            # flat-bottom z-row constants
            for nm in ("_top_c", "_top_u", "_top_v",
                       "_bot_c", "_bot_u", "_bot_v"):
                setattr(view, nm,
                        aux[nm] if nm in aux else getattr(model, nm, None))
            for nm in ("_lam_c", "_phi_c", "_lam_u", "_phi_u",
                       "_lam_v", "_phi_v"):
                if nm in aux:
                    setattr(view, nm, aux[nm])
            view._boundary_indicator = \
                lambda n, s: HY._boundary_indicator(view, n, s)
            view._boundary_value = \
                lambda st, n, s: HY._boundary_value(view, st, n, s)
            view._eval_cs_flux = lambda bc, n, s, st, t, dt_: \
                HY._eval_cs_flux(view, bc, n, s, st, t, dt_)
            view._zstar = zstar
            # blocked wet-column depths for the per-location σ over
            # bathymetry (None -> the flat-bottom cs_column_depth path)
            view._Hc = jnp.asarray(aux["_Hc"], state.u.dtype) \
                if "_Hc" in aux else None
            view._Hu = jnp.asarray(aux["_Hu"], state.u.dtype) \
                if "_Hu" in aux else None
            view._Hv = jnp.asarray(aux["_Hv"], state.u.dtype) \
                if "_Hv" in aux else None
            view._sigma_field = lambda e: HY._sigma_field(view, e)
            view._sigma_faces = lambda e: HY._sigma_faces(view, e)
            for nm in ("_frac_c", "_frac_u", "_frac_v"):
                setattr(view, nm, aux.get(nm))
            mu = jnp.asarray(mu_l, state.u.dtype)
            mv = jnp.asarray(mv_l, state.u.dtype)
            mc = jnp.asarray(mc_l, state.u.dtype)
            kin = jnp.asarray(kin_np, state.u.dtype)
            dtype = state.u.dtype
            if has_bath:
                wu3 = jnp.asarray(aux["_wet_u"], dtype)
                wv3 = jnp.asarray(aux["_wet_v"], dtype)
                ww3 = jnp.asarray(aux["_wet_w"], dtype)
                wc3 = jnp.asarray(aux["_wet_c"], dtype)
                w2c = jnp.asarray(aux["_wet2_c"], dtype)
                mu_t = mu * wu3
                mv_t = mv * wv3
                mc_eta = mc * w2c
                mc_tr = mc * wc3
            else:
                mu_t, mv_t, mc_eta, mc_tr = mu, mv, mc, mc

            def fill(u, v, tr, eta):
                if has_bath:
                    u = u * wu3
                    v = v * wv3
                    eta = eta * w2c
                res = _apply_exchange(
                    self.ex_uvtr, [u, v] + [tr[n] for n in names], dev)
                u = fill_z(res[0])
                v = fill_z(res[1])
                tr = {n: fill_z(self._corner_avg(res[2 + i], dev))
                      for i, n in enumerate(names)}
                eta = self._corner_avg(
                    _apply_exchange(self.ex_eta, [eta], dev)[0], dev)
                if has_bath:
                    u = HY._mirror_solid(view, u, wu3, aux["_bot_u"])
                    v = HY._mirror_solid(view, v, wv3, aux["_bot_v"])
                    tr = {n: HY._mirror_solid(view, c, wc3, aux["_bot_c"])
                          for n, c in tr.items()}
                return u, v, tr, eta

            def tendencies(u, v, eta, tr, t):
                zeta = jax.vmap(
                    lambda up, vp: vorticity_z_ff(lg, up, vp))(u, v)
                zeta = self._corner_fix(zeta, u, v, dev)
                sig = view._sigma_field(eta) if zstar else None
                if has_bath or zstar:
                    # neutral all-ones masks/σ keep the vmapped
                    # signatures uniform (×1.0 is bitwise exact)
                    ones2 = jnp.ones((u.shape[0], 1, 1, 1), u.dtype)
                    if has_bath:
                        wu_, wv_, ww_, wc_ = wu3, wv3, ww3, wc3
                    else:
                        wu_ = wv_ = ww_ = wc_ = ones2
                    sg = sig if sig is not None else ones2
                    if zstar:
                        sgu, sgv = view._sigma_faces(eta)
                    else:
                        sgu = sgv = ones2
                    # sg2d stays None unless partial cells are active
                    # (the serial sentinel is `sigma2d is not None`)
                    sg2d = None
                    if "_frac_c" in aux:
                        sg2d = sg
                        sg = sg * jnp.asarray(aux["_frac_c"], u.dtype)
                        sgu = sgu * jnp.asarray(aux["_frac_u"], u.dtype)
                        sgv = sgv * jnp.asarray(aux["_frac_v"], u.dtype)
                        wc_ = wc_ * jnp.asarray(aux["_frac_c"], u.dtype)
                    # edge-synced ω (mirrors the serial
                    # compute_tendencies)
                    Fxl, Fyl = jax.vmap(
                        partial(HY._panel_transport_fluxes, view))(
                        u, v, wu_, wv_, sg, sgu, sgv)
                    Fxl, Fyl = _apply_exchange(
                        self.ex_flux2d, [Fxl, Fyl], dev, mean=True)
                    w = jax.vmap(
                        partial(HY._panel_w_from_fluxes, view))(
                        Fxl, Fyl, sg, wc_)
                    Gu, Gv, w = jax.vmap(
                        partial(HY._panel_tendencies, view))(
                        u, v, eta, fff, zeta, tr, wu_, wv_, sg,
                        sgu, sgv, wc_, sg2d, w)
                    Fx, Fy, Ft = jax.vmap(
                        partial(HY._panel_fluxes, view))(
                        u, v, w, tr, wu_, wv_, ww_, sg, sgu, sgv)
                else:
                    Fxl, Fyl = jax.vmap(
                        partial(HY._panel_transport_fluxes, view))(u, v)
                    Fxl, Fyl = _apply_exchange(
                        self.ex_flux2d, [Fxl, Fyl], dev, mean=True)
                    w = jax.vmap(
                        partial(HY._panel_w_from_fluxes, view))(Fxl, Fyl)
                    Gu, Gv, w = jax.vmap(
                        partial(HY._panel_tendencies, view))(
                        u, v, eta, fff, zeta, tr, None, None, None,
                        None, None, None, None, w)
                    Fx, Fy, Ft = jax.vmap(partial(HY._panel_fluxes, view))(
                        u, v, w, tr)
                Fx, Fy = _apply_exchange(self.ex_flux2d, [Fx, Fy], dev,
                                         mean=True)
                if names:
                    arrays = []
                    for n in names:
                        arrays += [Ft[n][0], Ft[n][1]]
                    res = _apply_exchange(self.ex_fluxtr, arrays, dev,
                                          mean=True)
                    Ft = {n: (res[2 * i], res[2 * i + 1], Ft[n][2])
                          for i, n in enumerate(names)}
                if sig is None and "_frac_c" not in aux:
                    Geta, Gt = jax.vmap(
                        partial(HY._panel_divergences, view))(Fx, Fy, Ft)
                else:
                    # full per-cell thickness factor (σ × frac) — the
                    # same channel the fluxes were assembled with
                    Geta, Gt = jax.vmap(
                        partial(HY._panel_divergences, view))(Fx, Fy, Ft,
                                                              sg)
                diff = None
                if model.closure is not None:
                    def panel_closure(uu, vv, tts, wu_=None, wv_=None,
                                      wc_=None):
                        # w from the wet-MASKED transports, mirroring the
                        # serial panel_closure (the solid-cell mirror
                        # values must not feed the continuity cumsum);
                        # diffusive fluxes through solid faces zeroed via
                        # the solid-aware grid view
                        from oceananigans_tpu.models.cubed_sphere import (
                            _PanelSolidView,
                        )
                        uum = uu if wu_ is None else uu * wu_
                        vvm = vv if wv_ is None else vv * wv_
                        ww = HY._panel_w(view, uum, vvm)
                        gx = lg if wc_ is None \
                            else _PanelSolidView(lg, wc_ < 0.5)
                        d = closures_mod.compute_diffusivities(
                            model.closure, lg, uu, vv, ww, tts,
                            model._closure_buoyancy)
                        du, dv, _ = closures_mod.momentum_flux_divergences(
                            model.closure, gx, uu, vv, ww, tts, d,
                            include_implicit=False)
                        gt = {n: closures_mod.tracer_flux_divergence(
                            model.closure, gx, n, tts[n], tts, d,
                            include_implicit=False) for n in tts}
                        du = du + jnp.zeros_like(uu)
                        dv = dv + jnp.zeros_like(vv)
                        gt = {n: tt + jnp.zeros_like(tts[n])
                              for n, tt in gt.items()}
                        return du, dv, gt, d

                    if has_bath:
                        du, dv, gtc, diff = jax.vmap(panel_closure)(
                            u, v, tr, wu3, wv3, wc3)
                    else:
                        du, dv, gtc, diff = jax.vmap(panel_closure)(
                            u, v, tr)
                    Gu = Gu + du
                    Gv = Gv + dv
                    Gt = {n: Gt[n] + gtc[n] for n in Gt}
                if has_forcing:
                    for n, fn in model.forcings.items():
                        if n == "u":
                            Gu = Gu + fn(aux["_lam_u"], aux["_phi_u"],
                                         model._z_row, t)
                        elif n == "v":
                            Gv = Gv + fn(aux["_lam_v"], aux["_phi_v"],
                                         model._z_row, t)
                        else:
                            Gt[n] = Gt[n] + fn(lam, phi, model._z_row, t)
                if has_bcs:
                    sloc = SimpleNamespace(
                        clock=SimpleNamespace(time=t),
                        fields=lambda: {"u": u, "v": v, "eta": eta, **tr})
                    Gu, Gv, Gt = HY._apply_cs_flux_bcs(view, sloc, Gu,
                                                       Gv, Gt)
                if prescribed:
                    Gu = jnp.zeros_like(Gu)
                    Gv = jnp.zeros_like(Gv)
                    Geta = jnp.zeros_like(Geta)
                return (Gu * mu_t * kin, Gv * mv_t * kin, Geta * mc_eta,
                        {n: G * mc_tr * kin for n, G in Gt.items()}, diff)

            # free-surface machinery on the blocked layout: the same
            # cs_* functions as the serial model, with the block
            # exchange/sync/psum-dot injected (mirror-rank collectives
            # instead of stacked-axis gathers)
            from oceananigans_tpu.models.cubed_sphere import (
                cs_barotropic_correct, cs_barotropic_mode,
                cs_eta_gradients, cs_implicit_free_surface,
                cs_split_explicit_free_surface,
            )
            from oceananigans_tpu.models.hydrostatic import (
                ExplicitFreeSurface, ImplicitFreeSurface,
            )
            fs = model.free_surface

            def exch_eta(e):
                return self._corner_avg(
                    _apply_exchange(self.ex_eta, [e], dev)[0], dev)

            def sync2d(Fx, Fy):
                r = _apply_exchange(self.ex_flux2d, [Fx, Fy], dev,
                                    mean=True)
                return r[0], r[1]

            def psum_dot(x, y):
                mloc = jnp.asarray(mc_l, x.dtype)
                if has_bath:
                    mloc = mloc * jnp.asarray(aux["_wet2_c"], x.dtype)
                loc = jnp.sum(
                    lg.Az(_Center, _Center)[:, :, :1][None]
                    * mloc * x * y)
                return jax.lax.psum(loc, ("panel", "x", "y"))

            if has_bath:
                Hu_b = jnp.asarray(aux["_Hu"], dtype)
                Hv_b = jnp.asarray(aux["_Hv"], dtype)
                mu2 = mu * jnp.asarray(aux["_wet2_u"], dtype)
                mv2 = mv * jnp.asarray(aux["_wet2_v"], dtype)
                mc2 = mc * w2c
            else:
                Hu_b = Hv_b = None
                mu2, mv2, mc2 = mu, mv, mc

            def euler_fs(s_eta, s_U, s_V, u_e, v_e, Gu, Gv, Geta, dt_,
                         sigma_u=None, sigma_v=None):
                if prescribed:
                    return u_e, v_e, s_eta, s_U, s_V
                um = u_e * wu3 if has_bath else u_e
                vm = v_e * wv3 if has_bath else v_e
                # partial bottom cells: 3-D fractions join the mode
                # weights; the 2-D sigma alone scales the (already
                # fraction-aware) column depths (mirrors the serial
                # _euler_free_surface)
                mode_u, mode_v = sigma_u, sigma_v
                fru = frv = None
                if "_frac_u" in aux:
                    fru = jnp.asarray(aux["_frac_u"], u_e.dtype)
                    frv = jnp.asarray(aux["_frac_v"], u_e.dtype)
                    mode_u = fru if mode_u is None else mode_u * fru
                    mode_v = frv if mode_v is None else mode_v * frv
                if isinstance(fs, ExplicitFreeSurface):
                    eta_e = s_eta + dt_ * Geta
                    U_e, V_e = cs_barotropic_mode(lg, um, vm,
                                                  mode_u, mode_v)
                    return u_e, v_e, eta_e, U_e * mu2, V_e * mv2
                if isinstance(fs, ImplicitFreeSurface):
                    eta_e = cs_implicit_free_surface(
                        lg, um, vm, s_eta, dt_, fs, exch_eta, sync2d,
                        mc2, dot=psum_dot, Hu=Hu_b, Hv=Hv_b)
                    gx, gy = cs_eta_gradients(lg, eta_e)
                    u_e = u_e - dt_ * fs.g * gx * mu2
                    v_e = v_e - dt_ * fs.g * gy * mv2
                    um = u_e * wu3 if has_bath else u_e
                    vm = v_e * wv3 if has_bath else v_e
                    U_e, V_e = cs_barotropic_mode(lg, um, vm,
                                                  mode_u, mode_v)
                    return u_e, v_e, eta_e, U_e * mu2, V_e * mv2
                GU, GV = cs_barotropic_mode(lg, Gu, Gv, fru, frv)
                eta_f, U_f, V_f = cs_split_explicit_free_surface(
                    lg, s_U, s_V, s_eta, GU, GV, dt_, fs, exch_eta,
                    sync2d, mu2, mv2, Hu=Hu_b, Hv=Hv_b)
                u_c, v_c = cs_barotropic_correct(
                    lg, um, vm, U_f, V_f, mu2, mv2, Hu=Hu_b, Hv=Hv_b,
                    sigma_u=mode_u, sigma_v=mode_v,
                    depth_u=(sigma_u if sigma_u is not None
                             else jnp.ones((), u_e.dtype))
                    if fru is not None else None,
                    depth_v=(sigma_v if sigma_v is not None
                             else jnp.ones((), u_e.dtype))
                    if frv is not None else None)
                if has_bath:
                    u_c = u_c * wu3 + u_e * (1 - wu3)
                    v_c = v_c * wv3 + v_e * (1 - wv3)
                return u_c, v_c, eta_f, U_f, V_f

            has_cf = "_cf_x" in aux and not prescribed

            def apply_cf(u, v, tr, eta):
                """Corner-band filter on FILLED halos (the serial
                ``_apply_corner_filter`` sequence: fill → smooth →
                re-fill; ZStar smooths the σ-weighted content)."""
                if not has_cf:
                    return u, v, tr, eta
                smooth_c, smooth_v = _corner_filter_fns(
                    model, aux, cm, u.dtype)
                kin_f = jnp.asarray(kin_np, u.dtype)
                uf = smooth_v(u, mu_t * kin_f)
                vf = smooth_v(v, mv_t * kin_f)
                if zstar or "_frac_c" in aux:
                    one = jnp.ones((), eta.dtype)
                    sigma = view._sigma_field(eta) if zstar else one
                    if "_frac_c" in aux:
                        frc = jnp.asarray(aux["_frac_c"], eta.dtype)
                        sigma = sigma * frc
                    eta_f = smooth_c(eta)
                    sigma_f = view._sigma_field(eta_f) if zstar else one
                    if "_frac_c" in aux:
                        sigma_f = sigma_f * frc
                    trf = {n: smooth_c(tr[n] * sigma) / sigma_f
                           for n in names}
                else:
                    eta_f = smooth_c(eta)
                    trf = {n: smooth_c(tr[n]) for n in names}
                return fill(uf, vf, trf, eta_f)

            dt_ = jnp.asarray(dt, state.u.dtype)
            if getattr(model, "timestepper",
                       "RungeKutta3") == "QuasiAdamsBashforth2":
                from oceananigans_tpu.timesteppers import (
                    ab2_coefficients,
                )
                u, v, tr, eta = fill(state.u, state.v,
                                     dict(state.tracers), state.eta)
                c_now, c_prev = ab2_coefficients(state.clock.iteration)
                Gu, Gv, Geta, Gt, diff = tendencies(
                    u, v, eta, tr, state.clock.time)
                six_u = six_v = None
                if zstar:
                    sigma_n = view._sigma_field(eta)
                    six_u, six_v = view._sigma_faces(eta)
                    Gu = Gu * six_u
                    Gv = Gv * six_v
                    Gt = {n: Gt[n] * sigma_n for n in names}
                Gu_eff = c_now * Gu + c_prev * state.Gu
                Gv_eff = c_now * Gv + c_prev * state.Gv
                Geta_eff = c_now * Geta + c_prev * state.Geta
                Gt_eff = {n: c_now * Gt[n] + c_prev * state.Gtracers[n]
                          for n in names}
                if zstar:
                    u_e = u + dt_ * Gu_eff / six_u
                    v_e = v + dt_ * Gv_eff / six_v
                else:
                    u_e = u + dt_ * Gu_eff
                    v_e = v + dt_ * Gv_eff
                u, v, eta, U_, V_ = euler_fs(
                    eta, state.U, state.V, u_e, v_e, Gu_eff, Gv_eff,
                    Geta_eff, dt_, six_u, six_v)
                if zstar:
                    tr = {n: tr[n] + dt_ * Gt_eff[n] / sigma_n
                          for n in names}
                    sigma_np1 = view._sigma_field(eta)
                    ratio = sigma_n / sigma_np1
                    six_u1, six_v1 = view._sigma_faces(eta)
                    u = u * (six_u / six_u1)
                    v = v * (six_v / six_v1)
                    tr = {n: c * ratio for n, c in tr.items()}
                else:
                    tr = {n: tr[n] + dt_ * Gt_eff[n] for n in names}
                if implicit:
                    def panel_implicit(uu, vv, tts, dd):
                        return (closures_mod
                                .implicit_vertical_diffusion_step(
                                    lg, model.closure, dd, dt_,
                                    u=uu, v=vv, tracers=tts))
                    u, v, tr = jax.vmap(panel_implicit)(u, v, tr, diff)
                u, v, tr, eta = fill(u, v, tr, eta)
                u, v, tr, eta = apply_cf(u, v, tr, eta)
                return dataclasses.replace(
                    state, u=u, v=v, eta=eta, tracers=tr, U=U_, V=V_,
                    Gu=Gu, Gv=Gv, Geta=Geta, Gtracers=Gt,
                    clock=tick(state.clock, dt_))
            psi = (state.u, state.v, state.eta,
                   {n: state.tracers[n] for n in names},
                   state.U, state.V)
            u, v, eta = state.u, state.v, state.eta
            U_, V_ = state.U, state.V
            tr = dict(state.tracers)
            for gamma, zeta_c in ((1.0, 0.0), (0.25, 0.75),
                                  (2.0 / 3.0, 1.0 / 3.0)):
                u, v, tr, eta = fill(u, v, tr, eta)
                Gu, Gv, Geta, Gt, diff = tendencies(
                    u, v, eta, tr, state.clock.time)
                u_e = u + dt_ * Gu
                v_e = v + dt_ * Gv
                u_e, v_e, eta_e, U_e, V_e = euler_fs(
                    eta, U_, V_, u_e, v_e, Gu, Gv, Geta, dt_)
                un = zeta_c * psi[0] + gamma * u_e
                vn = zeta_c * psi[1] + gamma * v_e
                trn = {n: zeta_c * psi[3][n]
                       + gamma * (tr[n] + dt_ * Gt[n]) for n in names}
                if implicit:
                    def panel_implicit(uu, vv, tts, dd):
                        return closures_mod.implicit_vertical_diffusion_step(
                            lg, model.closure, dd, gamma * dt_,
                            u=uu, v=vv, tracers=tts)
                    un, vn, trn = jax.vmap(panel_implicit)(un, vn, trn,
                                                           diff)
                eta = zeta_c * psi[2] + gamma * eta_e
                U_ = zeta_c * psi[4] + gamma * U_e
                V_ = zeta_c * psi[5] + gamma * V_e
                u, v, tr = un, vn, trn
            u, v, tr, eta = fill(u, v, tr, eta)
            u, v, tr, eta = apply_cf(u, v, tr, eta)
            return dataclasses.replace(
                state, u=u, v=v, eta=eta, tracers=tr, U=U_, V=V_,
                clock=tick(state.clock, dt_))

        def step(state, dt):
            specs = state_specs(state)
            aux_specs = {k: P("panel", "x", "y", None)
                         for k in self.hy_aux}
            fn = shard_map(
                sstep, mesh=mesh,
                in_specs=(specs, P(), g2d_specs,
                          P("panel", "x", "y", None),
                          P("x", "y", None),
                          P("panel", "x", "y", None) if has_forcing
                          else P(),
                          P("panel", "x", "y", None) if has_forcing
                          else P(),
                          aux_specs, P("x", "y", None)),
                out_specs=specs, check_vma=False)
            z = jnp.zeros(())
            return fn(state, dt, fields2d, self.f_blocked,
                      self.cm_blocked,
                      self.lam_blocked if has_forcing else z,
                      self.phi_blocked if has_forcing else z,
                      self.hy_aux, self.cmke_blocked)

        return jax.jit(step)
