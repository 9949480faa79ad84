"""Hydrostatic model step-time decomposition on one chip.

Realistic global-ocean configuration: WENOVectorInvariant momentum,
WENO(7) tracer advection, split-explicit free surface, 2 tracers.
Reports per-phase times by benchmarking jitted sub-computations.

Usage: python tools/bench_hydrostatic.py [--nx 360 --ny 160 --nz 60]
"""

import argparse
import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from oceananigans_tpu import RectilinearGrid, Periodic, Bounded
from oceananigans_tpu.models import (
    HydrostaticFreeSurfaceModel, SplitExplicitFreeSurface,
    WENOVectorInvariant,
)
from oceananigans_tpu.advection import WENO
from oceananigans_tpu.platform import enable_compilation_cache


def timeit(fn, *args, inner=30, repeats=3):
    def body(i, x):
        out = fn(*((x,) + args[1:]))
        if jax.tree_util.tree_structure(out) == \
                jax.tree_util.tree_structure(x):
            return out
        # feed a data dependence back into the carry so nothing is DCE'd
        probe = sum(jnp.mean(l) for l in jax.tree_util.tree_leaves(out))
        return jax.tree_util.tree_map(
            lambda l: l + (1e-30 * probe).astype(l.dtype)
            if jnp.issubdtype(l.dtype, jnp.floating) else l, x)

    jitted = jax.jit(lambda x0: jax.lax.fori_loop(0, inner, body, x0))
    out = jax.block_until_ready(jitted(args[0]))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(jitted(args[0]))
        leaves = jax.tree_util.tree_leaves(out)
        float(jnp.sum(leaves[0].ravel()[:1]))
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def main():
    enable_compilation_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=360)
    p.add_argument("--ny", type=int, default=160)
    p.add_argument("--nz", type=int, default=60)
    p.add_argument("--inner", type=int, default=30)
    args = p.parse_args()
    Nx, Ny, Nz = args.nx, args.ny, args.nz

    grid = RectilinearGrid(size=(Nx, Ny, Nz),
                           extent=(4e7, 2e7, 4e3),
                           topology=(Periodic, Bounded, Bounded),
                           dtype="float32")
    model = HydrostaticFreeSurfaceModel(
        grid=grid,
        momentum_advection=WENOVectorInvariant(),
        tracer_advection=WENO(7),
        tracers=("T", "S"),
        free_surface=SplitExplicitFreeSurface(substeps=30),
    )
    state = model.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x / 4e7)
        * jnp.cos(np.pi * y / 2e7),
        T=lambda x, y, z: 20.0 + 8e-4 * z + 1e-7 * y,
        S=lambda x, y, z: 35.0 + 1e-8 * y,
    )
    dt = jnp.float32(60.0)

    npts = Nx * Ny * Nz
    t_step = timeit(lambda s: model.step(s, dt), state, inner=args.inner)
    print(f"full step: {t_step*1e3:8.2f} ms  "
          f"({npts/t_step/1e9:.3f} Gpts/s)")

    # decomposition: tendencies only
    t_tend = timeit(lambda s: model.compute_tendencies(s), state,
                    inner=args.inner)
    print(f"compute_tendencies: {t_tend*1e3:8.2f} ms")

    # momentum advection alone
    adv = model.momentum_advection
    u, v, w = state.u, state.v, state.w
    t_mom = timeit(lambda uu: (adv.u_tendency(grid, uu, v, w),
                               adv.v_tendency(grid, uu, v, w)), u,
                   inner=args.inner)
    print(f"VI momentum advection: {t_mom*1e3:8.2f} ms")

    # tracer advection alone
    from oceananigans_tpu.advection import div_Uc
    t_trc = timeit(lambda c: div_Uc(grid, model.tracer_advection,
                                    u, v, w, c), state.tracers["T"],
                   inner=args.inner)
    print(f"one tracer WENO7 advection: {t_trc*1e3:8.2f} ms")

    # vorticity term alone
    from oceananigans_tpu.ops.operators import vorticity_z_ff
    zeta = vorticity_z_ff(grid, u, v)
    t_zeta = timeit(lambda uu: (adv._zeta_v(grid, zeta, uu, v),
                                adv._zeta_u(grid, zeta, uu, v)), u,
                    inner=args.inner)
    print(f"  vorticity terms: {t_zeta*1e3:8.2f} ms")
    t_bern = timeit(lambda uu: (adv._bernoulli_u(grid, uu, v),
                                adv._bernoulli_v(grid, uu, v)), u,
                    inner=args.inner)
    print(f"  bernoulli terms: {t_bern*1e3:8.2f} ms")
    t_vert = timeit(lambda uu: (adv._vertical_u(grid, uu, v, w),
                                adv._vertical_v(grid, uu, v, w)), u,
                    inner=args.inner)
    print(f"  vertical+divergence terms: {t_vert*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
