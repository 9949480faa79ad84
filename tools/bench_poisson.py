"""Regular-grid Poisson solve on the card: FFT chain against dense
eigenbasis, and the matmul precision.

On the default bench cell's grid (256³ float32) this reports, for
``FFTPoissonSolver`` and for ``MatmulPoissonSolver`` at each
``lax.Precision``:

- ms per solve (median of 20 calls);
- the solution's max error against the float64 FFT solve on the CPU,
  relative to its max;
- max|∇·u| after 20 steps of the cell with that solver, raw and over
  max|u|/Δ_min, next to the same for a float64 run on the CPU.

The float64 CPU numbers come from a child process pinned to the CPU, so
that only this process opens the card.

    python tools/bench_poisson.py [N]
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 20


def _rhs(N):
    r = np.random.default_rng(0).standard_normal((N, N, N))
    return r - r.mean()


def _run_default(N, dtype, solver=None):
    import jax
    import jax.numpy as jnp

    import bench
    import chip_smoke
    model, state, dt = bench.build("default", (N, N, N), dtype)
    if solver is not None:
        model.pressure_solver = solver
    dt = jnp.asarray(dt, state.clock.time.dtype)
    run = jax.jit(lambda s: jax.lax.fori_loop(
        0, STEPS, lambda i, s_: model.step(s_, dt), s))
    return chip_smoke.normalized_divergence(model, run(state))


def cpu_reference(N, out):
    """Child mode: float64 on the CPU."""
    import chip_smoke
    from oceananigans_tpu import Bounded, Periodic, RectilinearGrid
    from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver
    with chip_smoke.float_type("float64"):
        grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                               topology=(Bounded, Periodic, Periodic),
                               halo=(1, 0, 0), dtype="float64")
        phi = np.asarray(FFTPoissonSolver(grid).solve(_rhs(N)))
        div, divn = _run_default(N, "float64")
    np.savez(out, phi=phi, div=div, divn=divn)


def main():
    import jax
    from jax import lax

    import chip_smoke
    from oceananigans_tpu import Bounded, Periodic, RectilinearGrid
    from oceananigans_tpu.platform import enable_compilation_cache
    from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver
    from oceananigans_tpu.solvers.matmul_poisson import MatmulPoissonSolver

    if len(sys.argv) > 2 and sys.argv[1] == "--cpu-reference":
        cpu_reference(int(sys.argv[2]), sys.argv[3])
        return
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("bench_poisson: no GPU found")
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.npz")
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference",
             str(N), ref_path], env=dict(os.environ, JAX_PLATFORMS="cpu"))
        grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                               topology=(Bounded, Periodic, Periodic),
                               halo=(1, 0, 0), dtype="float32")
        solvers = {"fft": FFTPoissonSolver(grid)}
        for p in (lax.Precision.DEFAULT, lax.Precision.HIGH,
                  lax.Precision.HIGHEST):
            s = MatmulPoissonSolver(grid)
            s.precision = p
            solvers[f"matmul_{p.name}"] = s
        rhs = jax.device_put(_rhs(N).astype(np.float32))
        rows = {}
        for name, s in solvers.items():
            solve = jax.jit(s.solve)
            phi = jax.block_until_ready(solve(rhs))
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                jax.block_until_ready(solve(rhs))
                times.append(time.perf_counter() - t0)
            div, divn = _run_default(N, "float32", s)
            rows[name] = {"ms_per_solve": float(np.median(times)) * 1e3,
                          "phi": np.asarray(phi), "max_div": div,
                          "max_div_normalized": divn}
        if child.wait() != 0:
            raise RuntimeError("float64 CPU reference failed")
        with np.load(ref_path) as ref:
            phi64 = ref["phi"]
            cpu = {"max_div": float(ref["div"]),
                   "max_div_normalized": float(ref["divn"])}
    scale = np.abs(phi64).max()
    for name, r in rows.items():
        phi = r.pop("phi").astype(np.float64)
        r["phi_rel_err_vs_cpu_f64"] = float(
            np.abs(phi - phi64).max() / scale)
        print(json.dumps({"solver": name, "N": N, "dtype": "float32",
                          "device_kind": dev.device_kind, **r}),
              flush=True)
    print(json.dumps({"solver": "fft", "N": N, "dtype": "float64",
                      "device_kind": "cpu", **cpu}), flush=True)


if __name__ == "__main__":
    main()
