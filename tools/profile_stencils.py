"""Device time and bandwidth share of the stencil updates of the hot cells.

For each hot bench cell this jits the part of the step that a fused
kernel used to do in one pass (tendencies + time-step update), runs it
under ``jax.profiler``, and reports, per device line of the trace, the
busy time of one call, the least bytes that part has to move (each
prognostic and tendency field read once and written once), and that
over the busy time as a share of the card's bandwidth.

    python tools/profile_stencils.py [--out DIR] [cell ...]

Cells default to all five. Traces go to ``DIR/<cell>/`` (default
``profiles/`` in the checkout); one JSON line per cell goes to stdout.
"""

import argparse
import glob
import json
import os
import shutil
import sys
import time

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
from oceananigans_tpu.platform import enable_compilation_cache  # noqa: E402

#: published HBM bandwidth by device kind (bytes/s), NVIDIA data sheets
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

CALLS = 10


def _ab2_update(model, state, dt):
    """Tendencies + quasi-AB2 update of every prognostic field (what the
    fused ``*_ab2_update`` kernels did)."""
    c_now, c_prev = 1.6, -0.6
    Gu, Gv, Gw, Gt, _ = model.compute_tendencies(state)
    new = {"u": state.u + dt * (c_now * Gu + c_prev * state.Gu),
           "v": state.v + dt * (c_now * Gv + c_prev * state.Gv),
           "w": state.w + dt * (c_now * Gw + c_prev * state.Gw)}
    for n in model.tracer_names:
        new[n] = state.tracers[n] + dt * (c_now * Gt[n]
                                          + c_prev * state.Gtracers[n])
    return new, (Gu, Gv, Gw, Gt)


def _hydro_tendencies(model, state, dt):
    """VI momentum + WENO tracer tendencies (what ``vi_momentum_tendency``
    and ``weno_tracer_tendencies`` did)."""
    from oceananigans_tpu.advection import div_Uc
    g, ma = model.grid, model.momentum_advection
    u, v, w = state.u, state.v, state.w
    out = {"Gu": ma.u_tendency(g, u, v, w), "Gv": ma.v_tendency(g, u, v, w)}
    for n in model.tracer_names:
        out["G" + n] = -div_Uc(g, model.tracer_advection, u, v, w,
                               state.tracers[n])
    return out


def _sw_stage(model, state, dt):
    """One RK3 stage: tendencies + update (what ``sw_rk3_stage`` did)."""
    gamma, zeta = 8.0 / 15.0, 0.0
    Guh, Gvh, Gh, _ = model.compute_tendencies(state)
    return (state.uh + dt * (gamma * Guh + zeta * state.Guh),
            state.vh + dt * (gamma * Gvh + zeta * state.Gvh),
            state.h + dt * (gamma * Gh + zeta * state.Gh), Guh, Gvh, Gh)


#: cell -> (function, fields read, fields written), counted on the
#: halo-extended arrays
CELLS = {
    "default": (_ab2_update, 6, 6),    # u v w Gu Gv Gw
    "science": (_ab2_update, 10, 10),  # + b c and their G
    "weno": (_ab2_update, 10, 10),     # + T S and their G
    "hydro_vi": (_hydro_tendencies, 5, 4),   # u v w T S -> Gu Gv GT GS
    "sw8192": (_sw_stage, 6, 6),       # uh vh h G*  (one of 3 stages)
}


def _union(intervals):
    total, end = 0, -1
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce_trace(path, calls):
    """Per device line: busy ns per call (union of event intervals),
    event count, and the five costliest event names."""
    data = jax.profiler.ProfileData.from_file(path)
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            if not evs:
                continue
            by_name = {}
            for e in evs:
                by_name[e.name] = by_name.get(e.name, 0) + e.duration_ns
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
            out[f"{plane.name}|{line.name}"] = {
                "busy_ns_per_call": _union(
                    (e.start_ns, e.end_ns) for e in evs) / calls,
                "events": len(evs),
                "top": [(n, t / calls) for n, t in top]}
    return out


def profile(cell, outdir):
    fn, nread, nwrite = CELLS[cell]
    model, state, dt = bench.build(cell)
    dt = jnp.asarray(dt, state.clock.time.dtype)
    f = jax.jit(lambda s: fn(model, s, dt))
    jax.block_until_ready(f(state))
    t0 = time.perf_counter()
    for _ in range(CALLS):
        out = f(state)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / CALLS
    tdir = os.path.join(outdir, cell)
    shutil.rmtree(tdir, ignore_errors=True)
    with jax.profiler.trace(tdir):
        for _ in range(CALLS):
            out = f(state)
        jax.block_until_ready(out)
    path = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    lines = reduce_trace(path, CALLS)
    if not lines:
        names = [p.name for p in
                 jax.profiler.ProfileData.from_file(path).planes]
        raise RuntimeError(f"no device plane in the trace: {names}")
    field = next(iter(state.fields().values()))
    min_bytes = (nread + nwrite) * field.nbytes
    kind = jax.devices()[0].device_kind
    peak = PEAK_BYTES_PER_S.get(kind)   # None: no share for this card
    busiest = max(v["busy_ns_per_call"] for v in lines.values())
    return {"cell": cell, "shape": list(field.shape),
            "device_kind": kind, "wall_ms_per_call": wall * 1e3,
            "min_bytes": min_bytes,
            "device_busy_ms": busiest / 1e6,
            "peak_bytes_per_s": peak,
            "bandwidth_share": (min_bytes / (busiest * 1e-9) / peak
                                if peak else None),
            "lines": lines}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "profiles"))
    p.add_argument("cells", nargs="*", help=", ".join(CELLS))
    args = p.parse_args()
    enable_compilation_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("profile_stencils: no GPU found")
    for cell in args.cells or list(CELLS):
        print(json.dumps(profile(cell, args.out)), flush=True)


if __name__ == "__main__":
    main()
