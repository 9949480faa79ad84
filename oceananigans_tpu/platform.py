"""Platform-dependent choices, made in one place.

Every decision that depends on the backend JAX runs on is taken here, so
that the models and solvers ask one question instead of testing
``jax.default_backend()`` themselves:

- which transform the regular-grid Poisson solves use
  (:func:`poisson_transform`);
- which ``lax.Precision`` dense matrix products run at
  (:func:`matmul_precision`);
- where JAX keeps its persistent compilation cache
  (:func:`enable_compilation_cache`, called by the scripts only; importing
  the library sets nothing).

Each table below is keyed by platform and records why its entry was
chosen; a platform missing from a table takes the CPU entry.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import numpy as np
from jax import lax

__all__ = [
    "backend", "poisson_transform", "matmul_precision",
    "compilation_cache_dir", "enable_compilation_cache",
]

#: The checkout this package lives in: the default home of the compile
#: cache (a fixed path, so that a later process finds what an earlier one
#: compiled).
REPO_ROOT = Path(__file__).resolve().parent.parent

#: Regular-grid Poisson transform: "fft" is the DCT/FFT chain
#: (O(N³ log N) work, ``solvers/fft_poisson.py``); "matmul" is six dense
#: eigenbasis contractions (O(N⁴) work, ``solvers/matmul_poisson.py``).
#: On an H100 (80GB HBM3, 400 W limit) at 256³ float32 the FFT chain
#: takes 1.59 ms per solve against 1.84 ms for the dense basis at
#: HIGHEST, and its solution is closer to float64 (4.4e-7 against 2.2e-6
#: relative); the CPU keeps the O(N³ log N) chain. See PERF.md.
POISSON_TRANSFORM = {"cpu": "fft", "gpu": "fft"}

#: Precision of float32 dense products. On the H100 both ``DEFAULT`` and
#: ``HIGH`` run a float32 product at TF32-like accuracy: the 256³ Poisson
#: solution is off by 8e-4 of its maximum against 2.2e-6 at ``HIGHEST``
#: (PERF.md). So every platform asks for full float32 (float64 products
#: are exact either way).
MATMUL_PRECISION = {"cpu": lax.Precision.HIGHEST,
                    "gpu": lax.Precision.HIGHEST}


def backend() -> str:
    """The platform JAX computes on: "cpu" or "gpu"."""
    return jax.default_backend()


def _lookup(table, platform):
    return table.get(platform or backend(), table["cpu"])


def poisson_transform(platform: str | None = None) -> str:
    """"fft" or "matmul": the transform regular-grid Poisson and
    implicit free-surface solves use on ``platform`` (default: the
    current backend)."""
    return _lookup(POISSON_TRANSFORM, platform)


def matmul_precision(dtype, platform: str | None = None) -> lax.Precision:
    """Explicit ``lax.Precision`` for a dense product in ``dtype``."""
    if np.dtype(dtype) == np.float64:
        return lax.Precision.HIGHEST
    return _lookup(MATMUL_PRECISION, platform)


def compilation_cache_dir(root: os.PathLike | str = REPO_ROOT) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if it is set, else ``<root>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(Path(root) / ".jax_cache")


def enable_compilation_cache(root: os.PathLike | str = REPO_ROOT) -> str:
    """Point JAX's persistent compilation cache at
    :func:`compilation_cache_dir` and return that path. Where
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and this
    sets nothing. Scripts call this first; the library never does."""
    path = compilation_cache_dir(root)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
