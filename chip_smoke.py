"""GPU smoke run: the four model families, end to end, checked.

    python chip_smoke.py              # one GPU: phases (a) and (b)
    python chip_smoke.py --four-gpus  # four GPUs: phase (c) only

(a) Every bench cell (``bench.build``) at full width runs about 20 steps
    through ``Simulation(...).run()``. Checks: every field finite; for the
    nonhydrostatic cells max|∇·u| after the projection; for ``cs_global``
    the volume and salt-content drift.
(b) Nine reduced-size cases, float32 on the GPU, each compared with the
    same case run in float64 on the CPU. The reference runs in a child
    process pinned to the CPU, so that only this process opens the card.
(c) With ``--four-gpus``: the explicit-halo ``DistributedStep`` and the
    GSPMD ``sharded_step_fn`` nonhydrostatic 256³ model on a 2×2 mesh and
    the ``CubedSphereDistributedHydrostatic`` cs_global model on
    ``R=2, panels=1``, each compared with a one-device run of the same
    steps.

Each phase prints one JSON line. The last line of a run in which every
check passed is ``{"ok": true, "device": {...}}``. Without a GPU, or if
any phase fails, the script exits non-zero and prints no such line.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: max|∇·u| after the projection, over max|u|/Δ_min (the size of one
#: flux-difference term). A working float32 projection leaves round-off,
#: about 1e-7 of that scale; TF32 products (10-bit mantissa) or a wrong
#: transform leave 1e-3 or more. 1e-5 sits between the two.
DIVERGENCE_TOL = 1e-5
#: cs_global drift over the run: volume change over the ocean volume,
#: and salt-content change relative to the content. The float64 CPU
#: tests pin these at 1e-12 and 1e-9; float32 sums over 2e5 cells carry
#: round-off of order 1e-6, so the float32 bounds are 1e-6 and 1e-5.
VOLUME_TOL = 1e-6
SALT_TOL = 1e-5
#: one-device vs four-device runs of the same steps, max|diff| over the
#: field's max. The two are different float32 programs (the partitioned
#: FFT of GSPMD, the dense eigenbasis of the explicit-halo solve, other
#: sum orders), which on the 4-device CPU mesh already differ by up to
#: 2e-5 after 3 steps at 16³; a misplaced halo or shard differs by O(1).
DISTRIBUTED_RTOL = 1e-3


def emit(record):
    print(json.dumps(record), flush=True)


@contextlib.contextmanager
def float_type(dtype):
    """Run in ``dtype``: the library's default float type, and JAX's
    64-bit types enabled exactly when ``dtype`` is float64."""
    import jax

    from oceananigans_tpu.config import config
    old = config.float_type
    config.float_type = dtype
    try:
        with jax.enable_x64(dtype == "float64"):
            yield
    finally:
        config.float_type = old


# ---------------------------------------------------------------------------
# (a) full-width cells through Simulation.run
# ---------------------------------------------------------------------------

def _finite(state):
    import jax
    return all(bool(np.isfinite(np.asarray(leaf)).all())
               for leaf in jax.tree_util.tree_leaves(state)
               if np.issubdtype(np.asarray(leaf).dtype, np.floating))


def normalized_divergence(model, state):
    """(max|∇·u| over the interior, the same over max|u|/Δ_min)."""
    import jax.numpy as jnp

    from oceananigans_tpu.ops.operators import divergence_ccc
    g = model.grid
    div = g.interior(divergence_ccc(g, state.u, state.v, state.w))
    umax = max(float(jnp.max(jnp.abs(f))) for f in (state.u, state.v,
                                                    state.w))
    dmin = min(g.Lx / g.Nx, g.Ly / g.Ny, g.Lz / g.Nz)
    d = float(jnp.max(jnp.abs(div)))
    return d, d * dmin / umax


def cell_checks(config, model, state0, state):
    """{check: {"value", "limit", "ok"}} for one bench cell's run."""
    import bench
    finite = _finite(state)
    checks = {"finite": {"value": finite, "ok": finite}}
    if config in bench.NONHYDRO_CELLS:
        d, dn = normalized_divergence(model, state)
        checks["max_div"] = {"value": d}
        checks["max_div_normalized"] = {"value": dn,
                                        "limit": DIVERGENCE_TOL,
                                        "ok": dn <= DIVERGENCE_TOL}
    if config == "cs_global":
        scale = float(model.ocean_volume())
        dv = abs(float(model.total_volume(state))
                 - float(model.total_volume(state0))) / scale
        s0 = float(model.total_tracer(state0, "S"))
        ds = abs(float(model.total_tracer(state, "S")) - s0) / abs(s0)
        checks["volume_drift"] = {"value": dv, "limit": VOLUME_TOL,
                                  "ok": dv <= VOLUME_TOL}
        checks["salt_drift"] = {"value": ds, "limit": SALT_TOL,
                                "ok": ds <= SALT_TOL}
    return checks


def run_cell(config, size=None, steps=20, dtype="float32"):
    """Build bench cell ``config``, run ``steps`` steps through
    ``Simulation.run`` (compiles), then ``steps`` more (timed)."""
    import jax

    import bench
    from oceananigans_tpu.simulation import Simulation
    with float_type(dtype):
        model, state0, dt = bench.build(config, size, dtype)
        sim = Simulation(model, state0, dt=dt, stop_iteration=steps)
        t0 = time.perf_counter()
        sim.run()
        jax.block_until_ready(sim.state)
        first = time.perf_counter() - t0
        sim.stop_iteration = 2 * steps
        t0 = time.perf_counter()
        sim.run()
        jax.block_until_ready(sim.state)
        warm = (time.perf_counter() - t0) / steps
        checks = cell_checks(config, model, state0, sim.state)
    return {
        "phase": "a", "case": config,
        "shape": list(size or bench.FULL_SIZE[config]), "dtype": dtype,
        "steps": 2 * steps, "ms_per_step": warm * 1e3,
        "setup_compile_s": first - steps * warm,
        "checks": checks,
        "ok": all(c.get("ok", True) for c in checks.values()),
    }


# ---------------------------------------------------------------------------
# (b) reduced-size cases against a float64 CPU reference
# ---------------------------------------------------------------------------

def _run(model, state, dt, steps):
    import jax
    import jax.numpy as jnp
    dt = jnp.asarray(dt, state.clock.time.dtype)
    step = jax.jit(lambda s: model.step(s, dt))
    for _ in range(steps):
        state = step(state)
    return jax.block_until_ready(state)


def _case_nonhydro(dtype, small):
    import jax.numpy as jnp

    from oceananigans_tpu import Bounded, Periodic, RectilinearGrid
    from oceananigans_tpu.models import NonhydrostaticModel
    N = 32 if small else 64
    grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                           topology=(Bounded, Periodic, Periodic),
                           halo=(1, 0, 0), dtype=dtype)
    model = NonhydrostaticModel(grid=grid,
                                timestepper="QuasiAdamsBashforth2")
    state = model.initial_state(
        v=lambda x, y, z: 0.1 * jnp.sin(4 * np.pi * x)
        * jnp.cos(2 * np.pi * y) * jnp.cos(2 * np.pi * z))
    s = _run(model, state, 1e-3, 20)
    return {"u": s.u, "w": s.w}


def _case_nonhydro_weno(dtype, small):
    import jax.numpy as jnp

    from oceananigans_tpu import (
        Bounded, BuoyancyTracer, Periodic, RectilinearGrid,
    )
    from oceananigans_tpu.advection import WENO
    from oceananigans_tpu.models import NonhydrostaticModel
    N = 32 if small else 48
    grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                           topology=(Bounded, Periodic, Periodic),
                           halo=(3, 0, 0), dtype=dtype)
    model = NonhydrostaticModel(grid=grid, advection=WENO(5),
                                tracers=("b",), buoyancy=BuoyancyTracer())
    state = model.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * y)
        * jnp.cos(2 * np.pi * z),
        b=lambda x, y, z: 0.01 * jnp.cos(2 * np.pi * x))
    s = _run(model, state, 2e-3, 10)
    return {"u": s.u, "b": s.tracers["b"]}


def _case_hydro_implicit(dtype, small):
    from oceananigans_tpu import Bounded, Periodic, RectilinearGrid
    from oceananigans_tpu.models import HydrostaticFreeSurfaceModel
    from oceananigans_tpu.models.hydrostatic import ImplicitFreeSurface
    grid = RectilinearGrid(size=(48, 24, 4), x=(0, 1e5), y=(0, 5e4),
                           z=(-100, 0),
                           topology=(Periodic, Bounded, Bounded),
                           halo=3, dtype=dtype)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=ImplicitFreeSurface(solver_method="fft"))
    state = model.initial_state(
        eta=lambda x, y: 0.1 * np.sin(2 * np.pi * x / 1e5)
        * np.cos(np.pi * y / 5e4))
    s = _run(model, state, 50.0, 20)
    return {"eta": s.eta, "u": s.u}


def _case_hydro_vi(dtype, small):
    """WENOVectorInvariant momentum on a lat-lon grid."""
    from oceananigans_tpu import LatitudeLongitudeGrid
    from oceananigans_tpu.models import HydrostaticFreeSurfaceModel
    from oceananigans_tpu.models.hydrostatic import (
        ExplicitFreeSurface, WENOVectorInvariant,
    )
    grid = LatitudeLongitudeGrid(size=(48, 32, 8), longitude=(-30.0, 30.0),
                                 latitude=(15.0, 55.0), z=(-1000.0, 0.0),
                                 halo=6, dtype=dtype)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=WENOVectorInvariant(),
        free_surface=ExplicitFreeSurface())
    state = model.initial_state(
        u=lambda lam, phi, z: 0.5 * np.cos(np.deg2rad(phi)) + 0 * lam,
        eta=lambda lam, phi: 0.05 * np.sin(np.deg2rad(lam) * 6))
    s = _run(model, state, 30.0, 10)
    return {"u": s.u, "v": s.v, "eta": s.eta}


def _case_hydro_vi_thin(dtype, small):
    """nz-thin realistic layout: WENOVectorInvariant + WENO-7 tracer +
    split-explicit free surface."""
    import jax.numpy as jnp

    from oceananigans_tpu import Bounded, Periodic, RectilinearGrid
    from oceananigans_tpu.advection import WENO
    from oceananigans_tpu.models import HydrostaticFreeSurfaceModel
    from oceananigans_tpu.models.hydrostatic import (
        SplitExplicitFreeSurface, WENOVectorInvariant,
    )
    size = (64, 24, 12) if small else (244, 48, 12)
    grid = RectilinearGrid(size=size, extent=(4e6, 1e6, 2e3),
                           topology=(Periodic, Bounded, Bounded),
                           halo=(6, 6, 4), dtype=dtype)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=WENOVectorInvariant(),
        tracer_advection=WENO(7), tracers=("T",),
        free_surface=SplitExplicitFreeSurface(substeps=8))
    state = model.initial_state(
        u=lambda x, y, z: 0.3 * jnp.sin(2 * np.pi * x / 4e6),
        T=lambda x, y, z: 20.0 + 8e-4 * z)
    s = _run(model, state, 60.0, 10)
    return {"u": s.u, "v": s.v, "T": s.tracers["T"], "eta": s.eta}


def _case_tracer_weno7(dtype, small):
    """WENO(7) advection of two tracers."""
    import jax.numpy as jnp

    from oceananigans_tpu import Bounded, Periodic, RectilinearGrid
    from oceananigans_tpu.advection import WENO
    from oceananigans_tpu.models import NonhydrostaticModel
    N = 32 if small else 48
    grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                           topology=(Bounded, Periodic, Periodic),
                           halo=(4, 4, 4), dtype=dtype)
    model = NonhydrostaticModel(grid=grid, advection=WENO(7),
                                tracers=("a", "b"),
                                timestepper="QuasiAdamsBashforth2")
    state = model.initial_state(
        v=lambda x, y, z: 0.2 * jnp.sin(2 * np.pi * x),
        a=lambda x, y, z: jnp.cos(2 * np.pi * y) * z,
        b=lambda x, y, z: jnp.sin(2 * np.pi * z))
    s = _run(model, state, 2e-3, 10)
    return {"a": s.tracers["a"], "b": s.tracers["b"]}


def _case_cubed_sphere(dtype, small):
    """Cubed-sphere shallow water, solid-body rotation."""
    from oceananigans_tpu.grids.cubed_sphere_grid import (
        ConformalCubedSphereGrid,
    )
    from oceananigans_tpu.models.cubed_sphere import (
        CubedSphereShallowWaterModel, panel_vector_components,
    )
    a = 6.37122e6
    u0 = 2 * np.pi * a / (12 * 86400)
    grid = ConformalCubedSphereGrid((16, 1), z=(-1.0, 0.0), radius=a,
                                    halo=3, dtype=dtype)
    model = CubedSphereShallowWaterModel(grid)
    u, v = panel_vector_components(
        grid, lambda P: np.cross(np.array([0.0, 0.0, u0 / a]), P * a))
    state = model.initial_state(u=u, v=v, h=3000.0)
    s = _run(model, state, 300.0, 10)
    return {"h": s.h, "u": s.u}


def _case_tripolar(dtype, small):
    from oceananigans_tpu.grids.orthogonal import TripolarGrid
    from oceananigans_tpu.models import HydrostaticFreeSurfaceModel
    from oceananigans_tpu.models.hydrostatic import ExplicitFreeSurface
    grid = TripolarGrid(size=(32, 16, 3), southernmost_latitude=-75.0,
                        z=(-1000.0, 0.0), halo=2, dtype=dtype)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=ExplicitFreeSurface(), tracers=("c",))
    state = model.initial_state(
        c=lambda lam, phi, z: np.cos(np.deg2rad(phi)) + 0 * lam,
        eta=lambda lam, phi: 0.1 * np.sin(np.deg2rad(lam)))
    s = _run(model, state, 60.0, 10)
    return {"eta": s.eta, "c": s.tracers["c"]}


def _case_immersed(dtype, small):
    from oceananigans_tpu import Bounded, Periodic, RectilinearGrid
    from oceananigans_tpu.immersed import (
        GridFittedBottom, ImmersedBoundaryGrid,
    )
    from oceananigans_tpu.models import NonhydrostaticModel
    base = RectilinearGrid(size=(32, 1, 16), x=(0.0, 2.0), y=(0.0, 1.0),
                           z=(-1.0, 0.0),
                           topology=(Periodic, Periodic, Bounded),
                           halo=2, dtype=dtype)
    grid = ImmersedBoundaryGrid(
        base, GridFittedBottom(
            lambda x, y: -1.0 + 0.4 * np.exp(-((x - 1) / 0.3) ** 2)))
    model = NonhydrostaticModel(grid=grid)
    state = model.initial_state(u=lambda x, y, z: 0.1 + 0 * x)
    s = _run(model, state, 5e-3, 10)
    return {"u": s.u, "w": s.w}


#: name -> (case(dtype, small) -> {field: array}, atol). The tolerances
#: are those the cases were held to on their first accelerator; the
#: scale of the largest field sets each one (u ~ 0.5 m/s for the
#: hydrostatic VI cases, h ~ 3000 m on the cubed sphere).
REFERENCE_CASES = {
    "nonhydro": (_case_nonhydro, 5e-6),
    "nonhydro_weno": (_case_nonhydro_weno, 5e-6),
    "hydro_implicit": (_case_hydro_implicit, 5e-5),
    "hydro_vi": (_case_hydro_vi, 5e-4),
    "hydro_vi_thin": (_case_hydro_vi_thin, 5e-4),
    "tracer_weno7": (_case_tracer_weno7, 5e-6),
    "cubed_sphere": (_case_cubed_sphere, 5e-2),
    "tripolar": (_case_tripolar, 5e-5),
    "immersed": (_case_immersed, 5e-5),
}


def run_case(name, dtype, small=False):
    """{field: array} of one case run in ``dtype``."""
    fn, _ = REFERENCE_CASES[name]
    with float_type(dtype):
        return {k: np.asarray(v) for k, v in fn(dtype, small).items()}


def compare(name, got, ref):
    """{field: max|got − ref|} and whether all are within the case's
    atol (a NaN fails)."""
    atol = REFERENCE_CASES[name][1]
    diffs = {k: float(np.abs(got[k].astype(np.float64)
                             - ref[k].astype(np.float64)).max())
             for k in ref}
    return diffs, all(d <= atol for d in diffs.values())


def write_references(outdir, small=False):
    """Child-process mode: every case in float64 on the CPU, one .npz
    per case in ``outdir``."""
    for name in REFERENCE_CASES:
        np.savez(os.path.join(outdir, f"{name}.npz"),
                 **run_case(name, "float64", small))


def start_reference(outdir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--reference", outdir], env=env, cwd=ROOT)


def reference_phase(child, outdir):
    records = []
    got = {}
    for name in REFERENCE_CASES:
        t0 = time.perf_counter()
        got[name] = run_case(name, "float32")
        got[name + "_s"] = time.perf_counter() - t0
    rc = child.wait()
    if rc != 0:
        raise RuntimeError(f"float64 CPU reference process exited {rc}")
    for name in REFERENCE_CASES:
        with np.load(os.path.join(outdir, f"{name}.npz")) as ref:
            ref = {k: ref[k] for k in ref.files}
        diffs, ok = compare(name, got[name], ref)
        records.append({
            "phase": "b", "case": name,
            "shape": {k: list(v.shape) for k, v in got[name].items()},
            "dtype": "float32", "reference": "float64 on CPU",
            "wall_s_incl_compile": got[name + "_s"],
            "max_abs_diff": diffs, "atol": REFERENCE_CASES[name][1],
            "ok": ok})
    return records


# ---------------------------------------------------------------------------
# (c) four devices against one
# ---------------------------------------------------------------------------

def _rel_diff(a, b, names, interior):
    """{field: max|a − b| over max|b|}, over the interior cells."""
    out = {}
    for k in names:
        x = np.asarray(a[k], np.float64)[interior]
        y = np.asarray(b[k], np.float64)[interior]
        out[k] = float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
    return out


def _spread(state, n):
    """(distinct devices of the 3-D leaves, per-device share of their
    bytes): a sharded state puts 1/n of its fields on each device."""
    import jax
    devs = set()
    per = {}
    total = 0
    for leaf in jax.tree_util.tree_leaves(state):
        if getattr(leaf, "ndim", 0) < 3:
            continue
        devs |= set(leaf.sharding.device_set)
        for sh in leaf.addressable_shards:
            per[sh.device] = per.get(sh.device, 0) + sh.data.nbytes
        total += leaf.nbytes
    return len(devs), max(per.values()) / total


def _nonhydro_dist_setup(size):
    from oceananigans_tpu import Bounded, Periodic, RectilinearGrid
    from oceananigans_tpu.models import NonhydrostaticModel
    import jax.numpy as jnp
    grid = RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=(Periodic, Periodic, Bounded),
                           halo=1, dtype="float32")

    def make_model(g):
        return NonhydrostaticModel(grid=g,
                                   timestepper="QuasiAdamsBashforth2")

    model = make_model(grid)
    state = model.initial_state(
        u=lambda x, y, z: 0.01 * jnp.sin(6 * np.pi * x)
        * jnp.cos(8 * np.pi * y) * jnp.cos(np.pi * z),
        v=lambda x, y, z: 0.01 * jnp.cos(4 * np.pi * x)
        * jnp.sin(6 * np.pi * y))
    return grid, make_model, model, state


def _serial(model, state, dt, steps, device):
    import jax
    return _run(model, jax.device_put(state, device), dt, steps)


def dist_explicit_halo(devices, size=(256, 256, 256), steps=10):
    import jax
    from jax.sharding import Mesh

    from oceananigans_tpu.parallel import DistributedStep
    grid, make_model, model, state = _nonhydro_dist_setup(size)
    dt = 1e-4
    ref = _serial(model, state, dt, steps, devices[0])
    mesh = Mesh(np.array(devices).reshape(2, 2), ("x", "y"))
    dstep = DistributedStep(make_model, grid, mesh)
    step = dstep.step_fn()
    local = dstep.to_local_state(state)
    for _ in range(steps):
        local = step(local, dt)
    local = jax.block_until_ready(local)
    ndev, share = _spread(local, 4)
    out = dstep.from_local_state(local)
    names = ("u", "v", "w")
    return {"case": "explicit_halo_nonhydro", "mesh": [2, 2],
            "shape": list(size), "steps": steps,
            "rel_diff": _rel_diff(out.fields(), ref.fields(), names,
                                  grid.interior_slices),
            "devices": ndev, "max_device_share": share}


def dist_gspmd(devices, size=(256, 256, 256), steps=10):
    import jax

    from oceananigans_tpu.parallel import (
        Distributed, Partition, shard_state, sharded_step_fn,
    )
    grid, _, model, state = _nonhydro_dist_setup(size)
    dt = 1e-4
    ref = _serial(model, state, dt, steps, devices[0])
    dist = Distributed(Partition(2, 2), devices=list(devices))
    step = sharded_step_fn(model, dist, dt)
    s = shard_state(dist, state)
    for _ in range(steps):
        s = step(s)
    s = jax.block_until_ready(s)
    ndev, share = _spread(s, 4)
    return {"case": "gspmd_nonhydro", "mesh": [2, 2], "shape": list(size),
            "steps": steps,
            "rel_diff": _rel_diff(s.fields(), ref.fields(), ("u", "v", "w"),
                                  grid.interior_slices),
            "devices": ndev, "max_device_share": share}


def dist_cubed_sphere(devices, size=None, steps=10):
    import jax

    import bench
    from oceananigans_tpu.parallel.cubed_sphere_shard import (
        CubedSphereDistributedHydrostatic,
    )
    model, state, dt = bench.build("cs_global", size)
    ref = _serial(model, state, dt, steps, devices[0])
    dm = CubedSphereDistributedHydrostatic(model, R=2, panels=1,
                                           devices=list(devices))
    b = dm.to_local_state(state)
    for _ in range(steps):
        b = dm.step(b, dt)
    b = jax.block_until_ready(b)
    ndev, share = _spread(b, 4)
    out = dm.from_local_state(b)
    a = {"u": out.u, "v": out.v, "eta": out.eta, **out.tracers}
    r = {"u": ref.u, "v": ref.v, "eta": ref.eta, **ref.tracers}
    return {"case": "cubed_sphere_R2", "mesh": [1, 2, 2],
            "shape": list(size or bench.FULL_SIZE["cs_global"]),
            "steps": steps,
            "rel_diff": _rel_diff(a, r, sorted(r),
                                  (slice(None),) + model.grid.panel_grid
                                  .interior_slices[:2]),
            "devices": ndev, "max_device_share": share}


FOUR_DEVICE_CASES = (dist_explicit_halo, dist_gspmd, dist_cubed_sphere)


def judge_four(rec, rtol=DISTRIBUTED_RTOL):
    """Add the verdict: all four devices hold a share of about a quarter
    (explicit halos add their overlap, so at most 0.35), and the fields
    agree with the one-device run within ``rtol``."""
    rec["ok"] = (rec["devices"] == 4 and rec["max_device_share"] <= 0.35
                 and all(d <= rtol for d in rec["rel_diff"].values()))
    rec["rtol"] = rtol
    return rec


# ---------------------------------------------------------------------------

def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-device phase")
    p.add_argument("--reference", metavar="DIR",
                   help=argparse.SUPPRESS)   # child: float64 CPU refs
    args = p.parse_args(argv)

    import jax
    if args.reference:
        sys.path.insert(0, ROOT)
        write_references(args.reference)
        return 0
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform "
                 f"{devices[0].platform!r})")
    need = 4 if args.four_gpus else 1
    if len(devices) < need:
        sys.exit(f"chip_smoke: needs {need} GPUs, found {len(devices)}")
    sys.path.insert(0, ROOT)
    from oceananigans_tpu.platform import enable_compilation_cache
    cache = enable_compilation_cache()

    card = _card()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card.splitlines(),
          "jax": jax.__version__, "compile_cache": cache})

    records = []
    if args.four_gpus:
        for fn in FOUR_DEVICE_CASES:
            t0 = time.perf_counter()
            rec = judge_four(fn(devices[:4]))
            rec["phase"] = "c"
            rec["wall_s_incl_compile"] = time.perf_counter() - t0
            mem = [d.memory_stats() or {} for d in devices[:4]]
            rec["peak_bytes_in_use"] = [m.get("peak_bytes_in_use")
                                        for m in mem]
            emit(rec)
            records.append(rec)
        count = 4
    else:
        with tempfile.TemporaryDirectory() as refdir:
            child = start_reference(refdir)
            try:
                for config in ("default", "science", "weno", "hydro_vi",
                               "sw8192", "cs_global"):
                    rec = run_cell(config)
                    emit(rec)
                    records.append(rec)
                for rec in reference_phase(child, refdir):
                    emit(rec)
                    records.append(rec)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        count = len(devices)
    if not all(r["ok"] for r in records):
        bad = [r.get("case") for r in records if not r["ok"]]
        sys.exit(f"chip_smoke: failed: {bad}")
    dev = devices[0]
    emit({"ok": True, "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
