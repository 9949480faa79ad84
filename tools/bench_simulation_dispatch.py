"""Dispatch-amortization check: the C48
global ocean stepped through ``Simulation.run`` (which batches steps
into ``lax.fori_loop`` windows between schedule hits) should be within
1.2x of the raw windowed ``bench.py BENCH_CONFIG=cs_global`` number.

Uses bench.py's OWN ``cs_global_model`` builder so the comparison is
apples-to-apples. Prints both ms/step figures and the ratio."""

import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from bench import cs_global_model  # noqa: E402
from oceananigans_tpu.simulation import Simulation  # noqa: E402
from oceananigans_tpu.platform import enable_compilation_cache  # noqa: E402

STEPS = int(os.environ.get("BENCH_STEPS", "200"))


def main():
    enable_compilation_cache()
    model, state, N, Nz = cs_global_model()
    dt = 300.0

    # raw windowed step (the bench.py pattern)
    @partial(jax.jit, donate_argnums=0)
    def window(st):
        st = model.fill_state_halos(st)
        return jax.lax.fori_loop(
            0, STEPS, lambda i, s: model.step(s, dt, assume_filled=True),
            st)

    st = jax.block_until_ready(window(jax.tree_util.tree_map(
        jnp.copy, state)))
    t0 = time.perf_counter()
    st = jax.block_until_ready(window(st))
    float(np.asarray(st.eta).ravel()[0])
    raw = (time.perf_counter() - t0) / STEPS

    # through Simulation.run (default NaN-checker schedule -> 100-step
    # windows); first run pays the compile, the second measures
    sim = Simulation(model, state, dt=dt, stop_iteration=STEPS)
    sim.initialize()
    t0 = time.perf_counter()
    sim.run()
    jax.block_until_ready(sim.state.eta)
    simt = (time.perf_counter() - t0) / STEPS

    sim2 = Simulation(model, sim.state, dt=dt,
                      stop_iteration=int(sim.state.clock.iteration)
                      + STEPS)
    sim2.initialized = True
    sim2._stepn_cache = sim._stepn_cache
    sim2._step1 = sim._step1
    t0 = time.perf_counter()
    sim2.run()
    jax.block_until_ready(sim2.state.eta)
    simt2 = (time.perf_counter() - t0) / STEPS

    print(f"raw windowed:        {raw*1e3:7.2f} ms/step")
    print(f"Simulation.run cold: {simt*1e3:7.2f} ms/step")
    print(f"Simulation.run warm: {simt2*1e3:7.2f} ms/step "
          f"(ratio {simt2/raw:.2f}x)")


if __name__ == "__main__":
    main()
