"""Boundary conditions: classifications, functional halo filling, flux application.

Reference layer: ``src/BoundaryConditions/`` (SURVEY.md §2.4) —
classifications at ``boundary_condition_classifications.jl:15-64``, halo
filling at ``fill_halo_regions.jl:50-80``, flux-into-tendency at
``apply_flux_bcs.jl``.

Design: ``fill_halo_regions`` is a pure function
``array -> array`` that overwrites the halo rings according to the BC rules;
there are no per-side kernel launches — the whole fill is a few fused
dynamic-update-slices inside the jitted step. Axes are filled in x → y → z
order so edge/corner halos are consistent (each later axis re-fills the full
slab, reproducing the reference's fused corner handling).

Location-awareness: the rule applied on an axis depends on the field's
staggering *along that axis*. Wall-normal (Face-located) data on a Bounded
axis gets the wall value imposed on the wall face itself (which lives in the
first halo slot, see grids/__init__.py) plus an antisymmetric mirror;
Center-located data gets value/gradient/no-flux ghost mirrors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu.grids.base import (
    AXIS_NAMES, Bounded, Center, Connected, Face, Flat, Periodic,
)

# ---------------------------------------------------------------------------
# Classifications
# ---------------------------------------------------------------------------
PERIODIC = "periodic"
FLUX = "flux"
VALUE = "value"          # Dirichlet
GRADIENT = "gradient"    # Neumann
OPEN = "open"            # wall-normal / open boundary
COMMUNICATION = "communication"  # filled by distributed halo exchange
ZIPPER = "zipper"        # tripolar north fold
POLAR = "polar"          # lat-lon pole row: Dirichlet at the zonal mean


@dataclasses.dataclass
class BoundaryCondition:
    """A classification plus a condition.

    ``condition`` may be ``None``, a scalar, a broadcastable array over the
    boundary plane, or a callable. Callables are *continuous boundary
    functions* ``f(coord1, coord2, t)`` of the two transverse coordinates
    (broadcast-ready arrays) and time — the functional analog of the
    reference's ``ContinuousBoundaryFunction``
    (``src/BoundaryConditions/continuous_boundary_function.jl``).
    ``field_dependencies`` names prognostic fields whose boundary-adjacent
    interior values are passed positionally after ``t``
    (``f(c1, c2, t, u, v, ...)`` — reference
    ``FluxBoundaryCondition(f, field_dependencies=(:u, :v))``,
    ``continuous_boundary_function.jl``); supported where the model
    supplies its fields (flux BCs applied to tendencies).
    ``matching_scheme`` applies to Open boundaries only.
    """
    classification: str
    condition: Any = None
    matching_scheme: Any = None
    field_dependencies: tuple = ()

    def __repr__(self):
        return f"BoundaryCondition({self.classification}, {self.condition})"


def _bc_flatten(bc):
    if callable(bc.condition):
        return (), (bc.classification, bc.condition, bc.matching_scheme,
                    bc.field_dependencies)
    return (bc.condition,), (bc.classification, None, bc.matching_scheme,
                             bc.field_dependencies)


def _bc_unflatten(meta, leaves):
    cls, fn, scheme, deps = meta
    cond = fn if fn is not None else (leaves[0] if leaves else None)
    return BoundaryCondition(cls, cond, scheme, deps)


jax.tree_util.register_pytree_node(BoundaryCondition, _bc_flatten,
                                   _bc_unflatten)


def PeriodicBC():
    return BoundaryCondition(PERIODIC)


def FluxBC(q=None, field_dependencies=()):
    if isinstance(field_dependencies, str):
        field_dependencies = (field_dependencies,)
    return BoundaryCondition(FLUX, q,
                             field_dependencies=tuple(field_dependencies))


def ValueBC(v):
    return BoundaryCondition(VALUE, v)


def GradientBC(g):
    return BoundaryCondition(GRADIENT, g)


def OpenBC(v=None, matching_scheme=None):
    """Open (wall-normal) boundary. ``matching_scheme``:
    None -> impose the wall value (impenetrable when v is None);
    "flat_extrapolation" -> zero-gradient outflow (reference
    ``flat_extrapolation_open_boundary_matching_scheme.jl``);
    a ``PerturbationAdvection`` -> radiation scheme (reference
    ``perturbation_advection_open_boundary_matching_scheme.jl``)."""
    return BoundaryCondition(OPEN, v, matching_scheme)


def FlatExtrapolationOpenBC():
    return OpenBC(matching_scheme="flat_extrapolation")


@dataclasses.dataclass(frozen=True)
class PerturbationAdvection:
    """Radiation matching scheme: the boundary-normal velocity is split
    into a prescribed mean and a perturbation that is advected OUT of
    the domain by the mean flow with a backward-Euler step, plus
    relaxation toward the mean (strong on inflow, weak/off on outflow).
    Reference ``perturbation_advection_open_boundary_matching_scheme.jl``
    (right boundary: uⁿ⁺¹ = (uⁿ + Ũ uᵢ₋₁ⁿ⁺¹ + ū τ̃) / (1 + τ̃ + Ũ),
    Ũ = clamp(ū Δt/Δx, 0, 1), τ̃ = Δt/τ)."""
    inflow_timescale: float = 300.0
    outflow_timescale: float = float("inf")


def PerturbationAdvectionOpenBC(v=None, inflow_timescale=300.0,
                                outflow_timescale=float("inf")):
    return OpenBC(v, PerturbationAdvection(float(inflow_timescale),
                                           float(outflow_timescale)))


def CommunicationBC():
    return BoundaryCondition(COMMUNICATION)


@dataclasses.dataclass
class FieldBoundaryConditions:
    """west/east/south/north/bottom/top bundle
    (reference ``field_boundary_conditions.jl``)."""
    west: Optional[BoundaryCondition] = None
    east: Optional[BoundaryCondition] = None
    south: Optional[BoundaryCondition] = None
    north: Optional[BoundaryCondition] = None
    bottom: Optional[BoundaryCondition] = None
    top: Optional[BoundaryCondition] = None
    immersed: Optional[BoundaryCondition] = None

    def sides(self, axis: int):
        return ((self.west, self.east), (self.south, self.north),
                (self.bottom, self.top))[axis]


jax.tree_util.register_dataclass(
    FieldBoundaryConditions,
    data_fields=["west", "east", "south", "north", "bottom", "top",
                 "immersed"],
    meta_fields=[])


def default_bc(topo: str, loc: str, side: str) -> Optional[BoundaryCondition]:
    """Default regularization (reference
    ``field_boundary_conditions.jl`` `default_auxiliary/prognostic_bc`):
    Periodic axes -> periodic; Bounded + Center -> no-flux; Bounded + Face
    (wall-normal) -> impenetrable (open with zero wall value); Connected ->
    communication; Flat -> nothing.
    """
    if topo == Flat:
        return None
    if topo == Periodic:
        return PeriodicBC()
    if topo == Connected:
        return CommunicationBC()
    if loc == Face:
        return OpenBC(None)   # None -> impenetrable zero wall value
    return FluxBC(None)


def _pole_sides(grid):
    """("south"/"north" flags) for lat-lon grids whose y-faces reach the
    poles (reference ``latitude_south/north_auxiliary_bc``,
    ``field_boundary_conditions.jl:288-317``)."""
    phiF = getattr(grid, "phiF", None)
    if phiF is None or grid.N[1] <= 1:
        return (False, False)
    phi = np.asarray(phiF).reshape(-1)
    H, N = grid.H[1], grid.N[1]
    return (abs(phi[H] + 90.0) < 1e-6, abs(phi[H + N] - 90.0) < 1e-6)


def regularize_field_boundary_conditions(bcs, grid, loc):
    """Fill unspecified sides of ``bcs`` with topology/location defaults.

    On lat-lon grids reaching the poles, (Center, Center)-horizontal
    fields get the POLAR condition at pole rows: a Dirichlet value equal
    to the zonal mean of the polemost interior row, recomputed at each
    fill (the reference's ``PolarBoundaryCondition``,
    ``polar_boundary_condition.jl``). Vector components keep the
    ordinary wall conditions."""
    if bcs is None:
        bcs = FieldBoundaryConditions()
    south_pole, north_pole = _pole_sides(grid)
    cc_loc = loc[0] == Center and loc[1] == Center
    names = (("west", "east"), ("south", "north"), ("bottom", "top"))
    out = {}
    for axis in range(3):
        topo = grid.axis_topo(axis)
        for s, name in enumerate(names[axis]):
            bc = getattr(bcs, name)
            if bc is None:
                if cc_loc and name == "south" and south_pole:
                    bc = BoundaryCondition(POLAR, None)
                elif cc_loc and name == "north" and north_pole:
                    bc = BoundaryCondition(POLAR, None)
                else:
                    bc = default_bc(topo, loc[axis], name)
            elif topo == Periodic and bc.classification != PERIODIC:
                raise ValueError(
                    f"non-periodic BC on periodic axis {AXIS_NAMES[axis]}")
            out[name] = bc
    out["immersed"] = bcs.immersed
    return FieldBoundaryConditions(**out)


# ---------------------------------------------------------------------------
# Halo filling
# ---------------------------------------------------------------------------

def _axslice(axis, sl):
    out = [slice(None)] * 3
    out[axis] = sl
    return tuple(out)


def _transverse_coords(grid, axis, loc):
    """Broadcast-ready coordinate arrays of the two transverse axes, for
    evaluating continuous boundary functions."""
    coords = []
    for ax in range(3):
        if ax == axis:
            continue
        name = AXIS_NAMES[ax]
        arr = getattr(grid, f"{name}F" if loc[ax] == Face else f"{name}C")
        coords.append(arr)
    return tuple(coords)


def _bc_value(bc, grid, axis, loc, time, fields=None, idx=None):
    cond = bc.condition
    if cond is None:
        return None
    if hasattr(cond, "times") and hasattr(cond, "data"):
        # FieldTimeSeries-valued boundary condition: interpolate the
        # stored boundary slabs to the clock time INSIDE the jitted fill
        # (reference field_time_series_indexing.jl:179 — FTS BCs update
        # in the model loop). ``cond.data`` is (T, n1, n2): the interior
        # extents of the two transverse axes, embedded here into the
        # halo-extended slab the fill/flux machinery broadcasts.
        times = jnp.asarray(np.asarray(cond.times))
        data = jnp.asarray(np.asarray(cond.data))
        t = jnp.clip(0.0 if time is None else time, times[0], times[-1])
        i = jnp.clip(jnp.searchsorted(times, t, side="right") - 1,
                     0, times.shape[0] - 2)
        f = (t - times[i]) / jnp.maximum(times[i + 1] - times[i], 1e-30)
        d0 = jax.lax.dynamic_index_in_dim(data, i, 0, keepdims=False)
        d1 = jax.lax.dynamic_index_in_dim(data, i + 1, 0, keepdims=False)
        val = (1.0 - f) * d0 + f * d1
        t1, t2 = [ax for ax in range(3) if ax != axis]
        shape = [1, 1, 1]
        shape[t1], shape[t2] = grid.shape[t1], grid.shape[t2]
        full = jnp.zeros(tuple(shape), val.dtype)
        s1 = grid.interior_slices[t1]
        s2 = grid.interior_slices[t2]
        sl = [slice(None)] * 3
        sl[t1], sl[t2] = s1, s2
        return full.at[tuple(sl)].set(
            val.reshape(val.shape[0], val.shape[1], 1)
            if axis == 2 else (val.reshape(val.shape[0], 1, val.shape[1])
                               if axis == 1
                               else val.reshape(1, *val.shape)))
    if callable(cond):
        c1, c2 = _transverse_coords(grid, axis, loc)
        t = 0.0 if time is None else time
        deps = getattr(bc, "field_dependencies", ())
        if deps:
            if fields is None or idx is None:
                raise ValueError(
                    "field-dependent boundary conditions are supported "
                    "only where the model supplies its fields (flux BCs "
                    "applied to tendencies)")
            slabs = [fields[n][_axslice(axis, slice(idx, idx + 1))]
                     for n in deps]
            return cond(c1, c2, t, *slabs)
        return cond(c1, c2, t)
    return cond


def _fill_axis(a, grid, axis, loc_ax, left_bc, right_bc, left_val, right_val,
               grid_axis=None, dt=None):
    """Fill both halo rings of one axis. Pure; returns the updated array."""
    if grid_axis is None:
        grid_axis = axis
    H = grid.H[grid_axis]
    N = grid.N[grid_axis]
    if H == 0:
        return a
    nd = a.ndim

    def axsl(sl):
        out = [slice(None)] * nd
        out[axis] = sl
        return tuple(out)

    topo = grid.axis_topo(grid_axis)
    if topo == Periodic:
        a = a.at[axsl(slice(0, H))].set(a[axsl(slice(N, N + H))])
        a = a.at[axsl(slice(N + H, N + 2 * H))].set(a[axsl(slice(H, 2 * H))])
        return a
    if topo in (Connected,):
        return a  # filled by the distributed halo exchange

    # distances between mirrored point pairs, for gradient BCs
    name = AXIS_NAMES[grid_axis]
    coord = getattr(grid, f"{name}F" if loc_ax == Face else f"{name}C")
    coord = jnp.reshape(coord, (-1,))

    def mirror(side):  # (ghost indices, interior mirror indices) outward order
        if side == "left":
            return ([H - 1 - h for h in range(H)], [H + h for h in range(H)])
        return ([N + H + h for h in range(H)], [N + H - 1 - h for h in range(H)])

    for side, bc, val in (("left", left_bc, left_val),
                          ("right", right_bc, right_val)):
        if bc is None or bc.classification in (COMMUNICATION,):
            continue
        kind = bc.classification
        gi, mi = mirror(side)

        if kind == POLAR:
            # Dirichlet at the zonal mean of the polemost interior row
            # (recomputed from the current field — reference
            # ``update_pole_value!``). Ghosts mirror about that value.
            row = H if side == "left" else N + H - 1
            pole_row = a[axsl(slice(row, row + 1))]
            # zonal (axis-0) mean over the interior x range
            Hx, Nx = grid.H[0], grid.N[0]
            if a.shape[0] == Nx + 2 * Hx:
                interior_x = pole_row[Hx:Hx + Nx]
            else:
                interior_x = pole_row
            val = jnp.mean(interior_x, axis=0, keepdims=True)
            for g, m in zip(gi, mi):
                ghost = 2.0 * val - a[axsl(slice(m, m + 1))]
                a = a.at[axsl(slice(g, g + 1))].set(
                    jnp.broadcast_to(ghost, a[axsl(slice(g, g+1))].shape))
            continue

        if loc_ax == Face and kind in (OPEN, VALUE):
            wall = H if side == "left" else N + H
            ms = getattr(bc, "matching_scheme", None)
            if isinstance(ms, PerturbationAdvection):
                # radiation: implicit perturbation-advection update of
                # the wall-face value itself; ghosts copy the new wall
                # value. No-op when dt is unknown (first fill).
                adj = wall + 1 if side == "left" else wall - 1
                ubar = jnp.zeros((), a.dtype) if val is None else val
                dxw = jnp.abs(coord[wall] - coord[adj])
                dtv = jnp.zeros((), a.dtype) if dt is None else \
                    jnp.asarray(dt, a.dtype)
                cr = dtv / dxw * ubar
                outflowing = (ubar >= 0) if side == "right" else (ubar <= 0)
                tau = jnp.where(outflowing, ms.outflow_timescale,
                                ms.inflow_timescale)
                tt = dtv / tau
                u_adj = a[axsl(slice(adj, adj + 1))]
                u_wall = a[axsl(slice(wall, wall + 1))]
                if side == "right":
                    Ut = jnp.clip(cr, 0.0, 1.0)
                else:
                    Ut = -jnp.clip(cr, -1.0, 0.0)
                new = (u_wall + Ut * u_adj + ubar * tt) / (1.0 + tt + Ut)
                for h in range(0, H + 1):
                    g = wall - h if side == "left" else wall + h
                    if 0 <= g < N + 2 * H:
                        a = a.at[axsl(slice(g, g + 1))].set(
                            jnp.broadcast_to(new,
                                             a[axsl(slice(g, g+1))].shape))
                continue
            if ms == "flat_extrapolation":
                # zero-gradient outflow: wall face and ghosts copy the
                # nearest interior face value (reference
                # flat_extrapolation_open_boundary_matching_scheme.jl)
                src = wall + 1 if side == "left" else wall - 1
                edge = a[axsl(slice(src, src + 1))]
                for h in range(0, H + 1):
                    g = wall - h if side == "left" else wall + h
                    if 0 <= g < N + 2 * H:
                        a = a.at[axsl(slice(g, g + 1))].set(edge)
                continue
            # default: impose the wall-face value itself, then mirror
            # antisymmetrically about it. Left wall face index = H; right
            # wall face index = H + N (first halo slot).
            wv = jnp.zeros((), a.dtype) if val is None else val
            a = a.at[axsl(slice(wall, wall + 1))].set(
                jnp.broadcast_to(wv, a[axsl(slice(wall, wall + 1))].shape))
            for h in range(1, H + 1):
                g = wall - h if side == "left" else wall + h
                m = wall + h if side == "left" else wall - h
                if 0 <= g < N + 2 * H:
                    a = a.at[axsl(slice(g, g + 1))].set(
                        2.0 * wv - a[axsl(slice(m, m + 1))])
            continue

        for g, m in zip(gi, mi):
            mirror_slab = a[axsl(slice(m, m + 1))]
            if kind == VALUE:
                ghost = 2.0 * val - mirror_slab
            elif kind == GRADIENT:
                d = coord[m] - coord[g]
                sign = -1.0 if side == "left" else 1.0
                ghost = mirror_slab + sign * val * d
            else:  # FLUX (no-flux mirror), OPEN on centers, default
                ghost = mirror_slab
            a = a.at[axsl(slice(g, g + 1))].set(
                jnp.broadcast_to(ghost, a[axsl(slice(g, g + 1))].shape))
    return a


def fill_halo_regions(a, grid, bcs=None, loc=(Center, Center, Center),
                      time=None, dt=None, axes=(0, 1, 2)):
    """Return ``a`` with all halo rings filled per its boundary conditions.

    The functional analog of the reference's ``fill_halo_regions!``
    (``src/BoundaryConditions/fill_halo_regions.jl:50-80``). ``axes``
    restricts the fill to a subset of axes (used by the models'
    pre-projection fills, which only need the normal-component halo
    along each haloed axis).
    """
    if bcs is None:
        bcs = regularize_field_boundary_conditions(None, grid, loc)
    zipper = getattr(grid, "zipper", False)
    for axis in axes:
        lbc, rbc = bcs.sides(axis)
        # flux halos are no-flux mirror fills: the condition value enters
        # the tendency (apply_flux_bcs), never the halo — skip evaluating
        # it here (it may be field-dependent)
        lval = (_bc_value(lbc, grid, axis, loc, time)
                if lbc and lbc.classification != FLUX else None)
        rval = (_bc_value(rbc, grid, axis, loc, time)
                if rbc and rbc.classification != FLUX else None)
        if zipper and axis == 1 and a.shape[1] == grid.shape[1]:
            # tripolar north fold: south side gets the ordinary bounded
            # fill, the north halo is the Zipper fold (reference
            # fill_halo_regions_zipper.jl); horizontal velocities flip sign
            a = _fill_axis(a, grid, axis, loc[axis], lbc, None, lval, None)
            from oceananigans_tpu.grids.orthogonal import fill_zipper_north
            sign = -1.0 if (loc[0] == Face or loc[1] == Face) else 1.0
            a = fill_zipper_north(a, grid, loc, sign)
            continue
        a = _fill_axis(a, grid, axis, loc[axis], lbc, rbc, lval, rval,
                       dt=dt)
    return a


# ---------------------------------------------------------------------------
# Flux boundary conditions -> tendencies
# ---------------------------------------------------------------------------

def apply_flux_bcs(G, grid, bcs, loc=(Center, Center, Center), time=None,
                   fields=None):
    """Add boundary fluxes to a tendency array.

    Fluxes are oriented along the positive axis; a left-side flux ``q`` adds
    ``+q/Δ`` to the boundary-adjacent interior cell, a right-side flux adds
    ``-q/Δ`` (reference ``apply_flux_bcs.jl`` via
    ``compute_nonhydrostatic_tendencies.jl:202-208``).
    """
    spacings = (grid.dx(loc[0], Center), grid.dy(loc[1], Center),
                grid.dz(loc[2]))
    for axis in range(3):
        if grid.axis_topo(axis) == Flat:
            continue
        lbc, rbc = bcs.sides(axis)
        H, N = grid.H[axis], grid.N[axis]
        d = spacings[axis]
        for side, bc, idx, sign in (("left", lbc, H, +1.0),
                                    ("right", rbc, H + N - 1, -1.0)):
            if bc is None or bc.classification != FLUX or bc.condition is None:
                continue
            q = _bc_value(bc, grid, axis, loc, time, fields=fields, idx=idx)
            sl = _axslice(axis, slice(idx, idx + 1))
            dcell = d[_axslice(axis, slice(idx, idx + 1))] if d.ndim == 3 else d
            G = G.at[sl].add(sign * q / dcell)
    return G


# Reference long-form constructor names (``src/Oceananigans.jl`` exports
# FluxBoundaryCondition etc.; the short forms above match the reference's
# own internal aliases).
FluxBoundaryCondition = FluxBC
ValueBoundaryCondition = ValueBC
GradientBoundaryCondition = GradientBC
OpenBoundaryCondition = OpenBC
