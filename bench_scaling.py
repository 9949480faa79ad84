"""Weak-scaling benchmark harness over a device mesh.

Reference counterpart: the published MPI weak/strong scaling tables
(``docs/src/appendix/benchmarks.md:281-345``; 48-75% weak-scaling
efficiency). Here the domain grows with the mesh (fixed points/device) and
the sharded step (GSPMD over the (x, y) mesh) is timed.

On several GPUs this measures scaling over NVLink; on a single-host dev
box run it over virtual devices to validate the harness:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python bench_scaling.py
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu import Bounded, BuoyancyTracer, Periodic, \
    RectilinearGrid, WENO
from oceananigans_tpu.models import NonhydrostaticModel
from oceananigans_tpu.parallel import Distributed, Partition, shard_state, \
    sharded_step_fn
from oceananigans_tpu.platform import enable_compilation_cache


def count_collectives(jitted, *args):
    """Collective instructions in the compiled HLO — the per-step
    communication bound (must be independent of the
    advection order on the explicit-halo path)."""
    import re
    hlo = jitted.lower(*args).compile().as_text()
    # HLO lines read "%name = f32[...]{...} op-name(...)": count one per
    # instruction line whose op (not just its name) matches
    out = {op: 0 for op in ("collective-permute", "all-reduce",
                            "all-gather", "all-to-all", "reduce-scatter")}
    for line in hlo.splitlines():
        if "=" not in line:
            continue
        rhs = line.split("=", 1)[1]
        for op in out:
            if re.search(rf"(^|\s){op}(-start)?(\.\d+)?\(", rhs):
                out[op] += 1
                break
    return out


def run(n_devices, base=32, nz=32, inner=5, path="explicit"):
    """``path``: "explicit" = shard_map + ppermute halo exchange (bounded
    collectives; parallel/shard_step.py) or "gspmd" = compiler-partitioned
    whole-array stencils."""
    dist = Distributed(Partition(None, None),
                       devices=jax.devices()[:n_devices])
    px, py = dist.partition
    H = 3
    if path == "explicit":
        # interior must divide the mesh (local-halos layout)
        nx, ny = base * px, base * py
    else:
        # GSPMD shards the halo-extended global array directly
        nx, ny = base * px - 2 * H, base * py - 2 * H
    grid = RectilinearGrid(size=(nx, ny, nz), extent=(1.0, 1.0, 1.0),
                           topology=(Periodic, Periodic, Bounded), halo=H)

    def make_model(g):
        return NonhydrostaticModel(grid=g, advection=WENO(5),
                                   tracers=("b",),
                                   buoyancy=BuoyancyTracer())

    model = make_model(grid)
    state = model.initial_state(
        u=lambda x, y, z: 0.01 * jnp.sin(2 * np.pi * x),
        b=lambda x, y, z: 1e-5 * z)
    colls = None
    if path == "explicit" and n_devices > 1:
        from jax.sharding import Mesh
        from oceananigans_tpu.parallel import DistributedStep
        mesh = dist.mesh if hasattr(dist, "mesh") else Mesh(
            np.array(jax.devices()[:n_devices]).reshape(px, py),
            ("x", "y"))
        dstep = DistributedStep(make_model, grid, mesh)
        f = dstep.step_fn()
        state = dstep.to_local_state(state)
        step = lambda s: f(s, 1e-4)
        colls = count_collectives(f, state, 1e-4)
    else:
        state = shard_state(dist, state)
        step = sharded_step_fn(model, dist, 1e-4)
    state = jax.block_until_ready(step(state))      # compile
    t0 = time.perf_counter()
    for _ in range(inner):
        state = step(state)
    jax.block_until_ready(state.u)
    el = (time.perf_counter() - t0) / inner
    pts = grid.Nx * grid.Ny * grid.Nz
    return el, pts, colls


def run_hydrostatic(n_devices, base=32, nz=16, inner=5):
    """Weak-scaling probe for the realistic-ocean configuration:
    hydrostatic split-explicit free surface on the explicit-halo path
    (the whole step, barotropic scan included, inside one shard_map)."""
    from jax.sharding import Mesh
    from oceananigans_tpu.models import HydrostaticFreeSurfaceModel
    from oceananigans_tpu.models.hydrostatic import (
        SplitExplicitFreeSurface,
    )
    from oceananigans_tpu.parallel import DistributedStep

    dist = Distributed(Partition(None, None),
                       devices=jax.devices()[:n_devices])
    px, py = dist.partition
    grid = RectilinearGrid(size=(base * px, base * py, nz),
                           x=(0, 1e5 * px), y=(0, 1e5 * py),
                           z=(-1000.0, 0.0),
                           topology=(Periodic, Periodic, Bounded), halo=3)

    def make_model(g):
        return HydrostaticFreeSurfaceModel(
            grid=g, free_surface=SplitExplicitFreeSurface(substeps=20),
            tracers=("T",))

    model = make_model(grid)
    state = model.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x / 1e5),
        T=lambda x, y, z: 10.0 + 5e-3 * z)
    dt = 60.0
    colls = None
    if n_devices > 1:
        mesh = Mesh(np.array(jax.devices()[:n_devices]).reshape(px, py),
                    ("x", "y"))
        dstep = DistributedStep(make_model, grid, mesh)
        f = dstep.step_fn()
        state = dstep.to_local_state(state)
        step = lambda s: f(s, dt)
        colls = count_collectives(f, state, dt)
    else:
        jstep = jax.jit(lambda s: model.step(s, dt))
        step = jstep
    state = jax.block_until_ready(step(state))
    t0 = time.perf_counter()
    for _ in range(inner):
        state = step(state)
    jax.block_until_ready(state.u)
    el = (time.perf_counter() - t0) / inner
    return el, grid.Nx * grid.Ny * grid.Nz, colls


def run_cubed_sphere(R=1, panels=6, n=16, inner=3):
    """Cubed-sphere panel(+sub-panel) sharding probe: steps the shallow-
    water model over a ``cubed_sphere_partition`` mesh and counts the
    collectives GSPMD emits for the inter-panel exchange gathers (these
    ride all-gathers rather than neighbor permutes; this probe is the
    honest bound)."""
    from oceananigans_tpu.models.cubed_sphere import (
        CubedSphereShallowWaterModel, ConformalCubedSphereGrid,
        cubed_sphere_partition, panel_vector_components,
    )

    a = 6.37122e6
    grid = ConformalCubedSphereGrid((n, 1), z=(-1.0, 0.0), radius=a,
                                    halo=3)
    model = CubedSphereShallowWaterModel(
        grid, gravitational_acceleration=9.80616, rotation_rate=7.292e-5)
    u0 = 2 * np.pi * a / (12.0 * 86400)
    u, v = panel_vector_components(
        grid, lambda P: np.cross(np.array([0.0, 0.0, u0 / a]), P * a))
    state = model.initial_state(u=u, v=v,
                                h=grid.set_tracer(lambda lam, phi, z:
                                                  2.94e4 / 9.80616 + 0 * z))
    mesh, shard_state = cubed_sphere_partition(R=R, panels=panels)
    state = shard_state(state)
    step = jax.jit(lambda s: model.step(s, 300.0))
    colls = count_collectives(step, state)
    state = jax.block_until_ready(step(state))
    t0 = time.perf_counter()
    for _ in range(inner):
        state = step(state)
    jax.block_until_ready(state.h)
    el = (time.perf_counter() - t0) / inner
    return el, 6 * n * n, colls


def run_cubed_sphere_explicit(R=1, panels=6, n=16, inner=3):
    """Explicit mirror-rank cubed-sphere path
    (`parallel/cubed_sphere_shard.py`): the same step with precomputed
    per-device-pair ppermute rounds — bounded collectives, no
    all-gathers, independent of R and the advection order."""
    from oceananigans_tpu.models.cubed_sphere import (
        CubedSphereShallowWaterModel, ConformalCubedSphereGrid,
        panel_vector_components,
    )
    from oceananigans_tpu.parallel.cubed_sphere_shard import (
        CubedSphereDistributedSW,
    )

    a = 6.37122e6
    grid = ConformalCubedSphereGrid((n, 1), z=(-1.0, 0.0), radius=a,
                                    halo=3)
    model = CubedSphereShallowWaterModel(
        grid, gravitational_acceleration=9.80616, rotation_rate=7.292e-5)
    u0 = 2 * np.pi * a / (12.0 * 86400)
    u, v = panel_vector_components(
        grid, lambda P: np.cross(np.array([0.0, 0.0, u0 / a]), P * a))
    state = model.initial_state(u=u, v=v,
                                h=grid.set_tracer(lambda lam, phi, z:
                                                  2.94e4 / 9.80616 + 0 * z))
    dsw = CubedSphereDistributedSW(model, R=R, panels=panels)
    state = dsw.to_local_state(state)
    step = jax.jit(lambda s: dsw.step(s, 300.0))
    colls = count_collectives(step, state)
    state = jax.block_until_ready(step(state))
    t0 = time.perf_counter()
    for _ in range(inner):
        state = step(state)
    jax.block_until_ready(state.h)
    el = (time.perf_counter() - t0) / inner
    return el, 6 * n * n, colls


def main():
    enable_compilation_cache()
    if jax.devices()[0].platform == "cpu":
        print("# NOTE: virtual CPU devices share one host's cores — this "
              "run validates the sharded-step harness, NOT real scaling "
              "(efficiency numbers are meaningless here; run on several "
              "GPUs for real scaling).")
    counts = [n for n in (1, 2, 4, 8) if n <= len(jax.devices())]
    results = []
    t1 = None
    for n in counts:
        el, pts, colls = run(n)
        if t1 is None:
            t1 = el
        eff = t1 / el            # weak scaling: ideal keeps time constant
        results.append({"devices": n, "ms_per_step": el * 1e3,
                        "points": pts, "weak_efficiency": eff,
                        "collectives_per_step": colls})
        print(f"{n} devices: {el*1e3:8.2f} ms/step  {pts:9d} pts  "
              f"weak eff {eff:5.1%}  collectives/step "
              f"{sum(colls.values()) if colls else 0}")
    # hydrostatic split-explicit weak scaling on the explicit-halo path
    t1h = None
    for n in counts:
        el, pts, colls = run_hydrostatic(n)
        if t1h is None:
            t1h = el
        print(f"hydrostatic {n} devices: {el*1e3:8.2f} ms/step  "
              f"{pts:9d} pts  weak eff {t1h/el:5.1%}  collectives/step "
              f"{sum(colls.values()) if colls else 0}")

    # cubed-sphere sharding probes: 6-panel mesh, and (with >= 8 devices)
    # a sub-panel (panels=2, R=2) mesh
    cs_runs = [("panel-axis (6 dev)", dict(R=1, panels=6, n=16))]
    if len(jax.devices()) >= 8:
        cs_runs.append(("sub-panel R=2 (8 dev)", dict(R=2, panels=2, n=16)))
    for label, kw in cs_runs:
        if len(jax.devices()) < kw["panels"] * kw["R"] ** 2:
            continue
        el, pts, colls = run_cubed_sphere(**kw)
        print(f"cubed sphere {label}: {el*1e3:8.2f} ms/step  {pts:7d} pts  "
              f"collectives/step {sum(colls.values())} {colls}")
        el, pts, colls = run_cubed_sphere_explicit(**kw)
        print(f"cubed sphere {label} EXPLICIT: {el*1e3:8.2f} ms/step  "
              f"{pts:7d} pts  collectives/step {sum(colls.values())} "
              f"{colls}")

    print(json.dumps({"metric": "weak_scaling_efficiency",
                      "value": results[-1]["weak_efficiency"],
                      "unit": f"t(1)/t({counts[-1]}) at fixed pts/device",
                      "vs_baseline": results[-1]["weak_efficiency"] / 0.48}))


if __name__ == "__main__":
    main()
