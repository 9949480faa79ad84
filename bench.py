"""Benchmark harness.

Default: nonhydrostatic 256³ step throughput on one device, mirroring
the reference's headline benchmark
(``benchmark/benchmarkable_nonhydrostatic_model.jl:20-30``: median wall
time per ``time_step!`` of a default ``NonhydrostaticModel`` on a 256³
grid; V100 Float64 baseline 56.4 ms -> 0.2976e9 grid-points/s, see
BASELINE.md).

``BENCH_CONFIG`` selects a cell, each printing ONE JSON line
{"metric", "value", "unit", "vs_baseline", ...}:

- ``default``  — 256³ Centered-2 AB2 (the published-benchmark model);
- ``science``  — 256³ Centered-2 AB2 + f-plane + BuoyancyTracer +
  1 passive tracer;
- ``weno``     — 256³ WENO-5 momentum + 2 WENO-5 tracers, AB2;
- ``weno_mom`` — 256³ WENO-5 momentum only, AB2;
- ``hydro_vi`` — 360×160×60 hydrostatic WENOVectorInvariant + WENO-7
  tracers + split-explicit free surface (the realistic global config);
- ``sw8192``   — shallow-water 8192² (vs the reference's 166.8 ms V100
  Float64 row, ``docs/src/appendix/benchmarks.md:57``);
- ``cs_global`` — C48×16 cubed-sphere global ocean.

``build(config, size)`` constructs any cell at any size; ``chip_smoke.py``
and the tests use it too. Runs in float32 (the baselines are the
reference's published Float64 V100 numbers).
"""

import inspect
import json
import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from oceananigans_tpu import Bounded, Flat, Periodic, RectilinearGrid
from oceananigans_tpu.platform import enable_compilation_cache

BASELINE_PTS_PER_S = 256 ** 3 / 56.4e-3   # V100 Float64, benchmarks.md:107
SW_BASELINE_8192 = 166.8e-3               # V100 Float64, benchmarks.md:57

NONHYDRO_CELLS = ("default", "science", "weno", "weno_mom")

#: full-width size of each cell: (N, N, N) nonhydrostatic, (Nx, Ny, Nz)
#: hydrostatic, (N, N) shallow water, (N_panel, Nz) cubed sphere
FULL_SIZE = {
    **{c: (256, 256, 256) for c in NONHYDRO_CELLS},
    "hydro_vi": (360, 160, 60),
    "sw8192": (8192, 8192),
    "cs_global": (48, 16),
}


def _nonhydro(config, size, dtype):
    """Nonhydrostatic cells: the bounded (vertical) axis leads and the
    two periodic axes are halo-free (``jnp.roll`` wraps are the periodic
    boundary). Physically identical to the reference's
    (Periodic, Periodic, Bounded) benchmark box."""
    from oceananigans_tpu import BuoyancyTracer, FPlane
    from oceananigans_tpu.advection import WENO
    from oceananigans_tpu.models import NonhydrostaticModel
    halo = (3, 0, 0) if config in ("weno", "weno_mom") else (1, 0, 0)
    grid = RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=(Bounded, Periodic, Periodic),
                           halo=halo, dtype=dtype)
    kw = {}
    if config == "science":
        kw = dict(coriolis=FPlane(f=1e-4), buoyancy=BuoyancyTracer(),
                  tracers=("b", "c"))
    elif config == "weno":
        kw = dict(advection=WENO(5), tracers=("T", "S"))
    elif config == "weno_mom":
        kw = dict(advection=WENO(5))
    model = NonhydrostaticModel(grid=grid,
                                timestepper="QuasiAdamsBashforth2", **kw)
    tracers = {t: (lambda x, y, z: 0.01 * z + 0.001
                   * jnp.cos(2 * np.pi * y)) for t in model.tracer_names}
    state = model.initial_state(
        u=lambda x, y, z: 0.01 * jnp.sin(8 * np.pi * x)
        * jnp.cos(6 * np.pi * y) * jnp.cos(2 * np.pi * z),
        v=lambda x, y, z: 0.01 * jnp.cos(4 * np.pi * x)
        * jnp.sin(6 * np.pi * y), **tracers)
    return model, state, 1e-4


def _hydro_vi(size, dtype):
    from oceananigans_tpu.advection import WENO
    from oceananigans_tpu.models import (
        HydrostaticFreeSurfaceModel, SplitExplicitFreeSurface,
        WENOVectorInvariant,
    )
    grid = RectilinearGrid(size=size, extent=(4e7, 2e7, 4e3),
                           topology=(Periodic, Bounded, Bounded),
                           halo=(6, 6, 4), dtype=dtype)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=WENOVectorInvariant(),
        tracer_advection=WENO(7), tracers=("T", "S"),
        free_surface=SplitExplicitFreeSurface(substeps=30))
    state = model.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x / 4e7)
        * jnp.cos(np.pi * y / 2e7),
        T=lambda x, y, z: 20.0 + 8e-4 * z + 1e-7 * y,
        S=lambda x, y, z: 35.0 + 1e-8 * y)
    return model, state, 60.0


def _shallow_water(size, dtype):
    """Δt = 0.5 s: at 8192² (Δx = 122 m, c = 99 m/s) the C-grid gravity
    waves of RK3 stay stable below Δt ≈ 0.75 s; an earlier Δt = 1 s
    diverged within 30 steps."""
    from oceananigans_tpu.models import ShallowWaterModel
    # x halo 8, halo-free periodic y (roll wraps are the boundary)
    grid = RectilinearGrid(size=size, x=(0.0, 1e6), y=(0.0, 1e6),
                           topology=(Periodic, Periodic, Flat),
                           halo=(8, 0, 0), dtype=dtype)
    model = ShallowWaterModel(grid=grid, gravitational_acceleration=9.81)
    state = model.initial_state(
        h=lambda x, y, z: 1000.0 + jnp.sin(2 * np.pi * x / 1e6)
        * jnp.cos(2 * np.pi * y / 1e6),
        uh=lambda x, y, z: 100.0 * jnp.cos(2 * np.pi * y / 1e6))
    return model, state, 0.5


def _cs_global(size, dtype):
    """Continents + wind stress + heat flux + T/S + convective adjustment
    + split-explicit: the examples/global_ocean.py class of setup."""
    from oceananigans_tpu.boundary_conditions import (
        FieldBoundaryConditions, FluxBC,
    )
    from oceananigans_tpu.buoyancy import SeawaterBuoyancy
    from oceananigans_tpu.closures import (
        ConvectiveAdjustmentVerticalDiffusivity,
    )
    from oceananigans_tpu.grids.cubed_sphere_grid import (
        ConformalCubedSphereGrid,
    )
    from oceananigans_tpu.models.cubed_sphere import (
        CubedSphereHydrostaticModel,
    )
    from oceananigans_tpu.models.hydrostatic import (
        SplitExplicitFreeSurface,
    )
    depth = 3000.0

    def continents(lam, phi):
        land = (np.abs(lam + 60.0) < 25.0) & (phi > -55.0) & (phi < 70.0)
        land |= (np.abs(lam - 45.0) < 50.0) & (phi > 0.0) & (phi < 70.0)
        land |= np.abs(phi) > 78.0
        return np.where(land, 50.0, -depth)

    grid = ConformalCubedSphereGrid(size, z=(-depth, 0.0),
                                    radius=6.37122e6, halo=3, dtype=dtype)
    model = CubedSphereHydrostaticModel(
        grid, bathymetry=continents, buoyancy=SeawaterBuoyancy(),
        closure=ConvectiveAdjustmentVerticalDiffusivity(
            convective_kappa_z=0.1, background_kappa_z=1e-5),
        free_surface=SplitExplicitFreeSurface(substeps=20),
        boundary_conditions={
            "u": FieldBoundaryConditions(top=FluxBC(
                lambda lam, phi, t: -8e-5
                * jnp.sin(jnp.deg2rad(3 * phi)))),
            "T": FieldBoundaryConditions(top=FluxBC(
                lambda lam, phi, t: -2e-5
                * jnp.cos(jnp.deg2rad(2 * phi))))},
        tracers=())
    state = model.initial_state(
        T=lambda lam, phi, z: 5.0 + 20.0
        * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 800.0), S=35.0)
    return model, state, 300.0


def build(config, size=None, dtype="float32"):
    """(model, initial state, dt) of bench cell ``config`` at ``size``
    (default: the cell's full width, ``FULL_SIZE``)."""
    size = tuple(size or FULL_SIZE[config])
    if config in NONHYDRO_CELLS:
        return _nonhydro(config, size, dtype)
    if config == "hydro_vi":
        return _hydro_vi(size, dtype)
    if config == "sw8192":
        return _shallow_water(size, dtype)
    if config == "cs_global":
        return _cs_global(size, dtype)
    raise ValueError(f"unknown bench cell {config!r}")


def cs_global_model():
    """The cs_global cell at ``BENCH_N``×``BENCH_NZ`` (default C48×16):
    (model, state, N, Nz)."""
    N = int(os.environ.get("BENCH_N", "48"))
    Nz = int(os.environ.get("BENCH_NZ", "16"))
    model, state, _ = build("cs_global", (N, Nz))
    return model, state, N, Nz


def npoints(config, size=None):
    size = tuple(size or FULL_SIZE[config])
    if config == "cs_global":
        return 6 * size[0] ** 2 * size[1]
    return int(np.prod(size))


def bench_window(model, state, dt, inner, repeats):
    """Best per-step time over ``repeats`` windows of ``inner`` steps,
    each window one jitted ``fori_loop`` ending in ``block_until_ready``
    (the first window compiles and is not counted)."""
    dt = jnp.asarray(dt, state.clock.time.dtype)
    # as in Simulation: one fill at window entry, then steps that skip
    # their redundant leading fill where the model offers that
    filled = "assume_filled" in inspect.signature(model.step).parameters

    @partial(jax.jit, donate_argnums=0)
    def multi_step(st):
        if not filled:
            return jax.lax.fori_loop(
                0, inner, lambda i, s_: model.step(s_, dt), st)
        st = model.fill_state_halos(st)
        return jax.lax.fori_loop(
            0, inner, lambda i, s_: model.step(s_, dt, assume_filled=True),
            st)

    state = jax.block_until_ready(multi_step(state))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = jax.block_until_ready(multi_step(state))
        best = min(best, (time.perf_counter() - t0) / inner)
    return best, state


def _env_size(config):
    full = FULL_SIZE[config]
    if config in NONHYDRO_CELLS:
        N = int(os.environ.get("BENCH_N", full[0]))
        return (N, N, N)
    if config == "hydro_vi":
        return tuple(int(os.environ.get(k, d))
                     for k, d in zip(("BENCH_NX", "BENCH_NY", "BENCH_NZ"),
                                     full))
    if config == "sw8192":
        N = int(os.environ.get("BENCH_N", full[0]))
        return (N, N)
    return (int(os.environ.get("BENCH_N", full[0])),
            int(os.environ.get("BENCH_NZ", full[1])))


DEFAULT_INNER = {"weno": 60, "weno_mom": 60, "hydro_vi": 30,
                 "sw8192": 60, "cs_global": 20}


def main():
    enable_compilation_cache()
    config = os.environ.get("BENCH_CONFIG", "default")
    if config not in FULL_SIZE:
        raise SystemExit(f"unknown BENCH_CONFIG {config!r}")
    inner = int(os.environ.get("BENCH_INNER",
                               DEFAULT_INNER.get(config, 150)))
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    size = _env_size(config)
    model, state, dt = build(config, size)
    best, _ = bench_window(model, state, dt, inner, repeats)
    pts = npoints(config, size) / best
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if config in NONHYDRO_CELLS:
        N = size[0]
        tag = "" if config == "default" else f"_{config}"
        out = {
            "metric": f"nonhydrostatic_{N}cubed{tag}_points_per_s",
            "value": pts,
            "unit": "grid-points/s/device (float32)",
            "vs_baseline": pts / BASELINE_PTS_PER_S,
            # apples-to-apples: the reference's published float32 V100
            # time (38.8 ms, docs/src/appendix/benchmarks.md:124)
            "vs_baseline_f32": pts / (N ** 3 / 38.8e-3)
            if N == 256 and config == "default" else None,
        }
    elif config == "hydro_vi":
        out = {
            "metric": "hydrostatic_vi_{}x{}x{}_points_per_s".format(*size),
            "value": pts,
            "unit": "grid-points/s/device (float32)",
            # per-point cost vs the reference's nonhydrostatic headline
            # (no published hydrostatic V100 row exists)
            "vs_baseline": pts / BASELINE_PTS_PER_S,
        }
    elif config == "sw8192":
        N = size[0]
        # published rows: 8192² = 166.8 ms, 16384² = 681.2 ms (V100 f64,
        # benchmarks.md:57-58); other sizes scale the 8192² row by area
        baseline = {8192: 166.8e-3, 16384: 681.2e-3}.get(
            N, SW_BASELINE_8192 * (N / 8192) ** 2)
        out = {
            "metric": f"shallow_water_{N}sq_ms_per_step",
            "value": best * 1e3,
            "unit": "ms/step (float32)",
            "vs_baseline": baseline / best,   # speedup over V100 f64 row
        }
    else:
        out = {
            "metric": "cubed_sphere_global_ocean_C{}x{}_ms_per_step".format(
                *size),
            "value": best * 1e3,
            "unit": "ms/step (float32)",
            "vs_baseline": None,    # no published cubed-sphere row exists
            "points_per_s": pts,
        }
    out["ms_per_step"] = best * 1e3
    out["device"] = device
    print(json.dumps(out))


if __name__ == "__main__":
    main()
