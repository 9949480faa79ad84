"""The one place platform decisions are made (``platform.py``), the
package's installation needs, and ``chip_smoke.py`` refusing to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax import lax

from oceananigans_tpu import platform
from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver
from oceananigans_tpu.solvers.pressure_solver import make_pressure_solver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_poisson_transform_per_platform(name):
    assert platform.poisson_transform(name) == \
        platform.POISSON_TRANSFORM[name]
    assert platform.poisson_transform(name) in ("fft", "matmul")


def test_unknown_platform_takes_the_cpu_choice():
    assert platform.poisson_transform("elsewhere") == \
        platform.POISSON_TRANSFORM["cpu"]
    assert platform.matmul_precision(np.float32, "elsewhere") == \
        platform.MATMUL_PRECISION["cpu"]


def test_backend_is_cpu_here_and_solver_follows():
    from oceananigans_tpu import Bounded, Periodic, RectilinearGrid
    assert platform.backend() == "cpu"
    grid = RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                           topology=(Bounded, Periodic, Periodic),
                           halo=(1, 0, 0))
    assert isinstance(make_pressure_solver(grid), FFTPoissonSolver)


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_float32_products_never_tf32(name):
    """A float32 product asks for full float32 precision on every
    platform: DEFAULT would let a GPU use TF32."""
    assert platform.matmul_precision(np.float32, name) == \
        lax.Precision.HIGHEST
    assert platform.matmul_precision(np.float64, name) == \
        lax.Precision.HIGHEST


def test_regrid_asks_for_explicit_precision():
    import jax.numpy as jnp

    from oceananigans_tpu import Bounded, Flat, RectilinearGrid
    from oceananigans_tpu.fields import regrid
    src = RectilinearGrid(size=(8,), z=(0.0, 1.0),
                          topology=(Flat, Flat, Bounded))
    dst = RectilinearGrid(size=(4,), z=(0.0, 1.0),
                          topology=(Flat, Flat, Bounded))
    a = jnp.ones(src.shape)
    text = jax.jit(lambda x: regrid(src, dst, x)).lower(a).as_text()
    assert "HIGHEST" in text.upper()


def test_compile_cache_path_without_env(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert platform.compilation_cache_dir(tmp_path) == \
        str(tmp_path / ".jax_cache")
    assert platform.compilation_cache_dir() == \
        os.path.join(ROOT, ".jax_cache")


def test_compile_cache_path_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert platform.compilation_cache_dir() == str(tmp_path / "c")


def test_enable_compilation_cache_sets_only_without_env(monkeypatch,
                                                        tmp_path):
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
        jax.config.update("jax_compilation_cache_dir", None)
        assert platform.enable_compilation_cache(tmp_path) == \
            str(tmp_path / "e")
        assert jax.config.jax_compilation_cache_dir is None
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert platform.enable_compilation_cache(tmp_path) == \
            str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == \
            str(tmp_path / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_importing_the_package_sets_no_cache():
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, oceananigans_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, capture_output=True, text=True,
        env={k: v for k, v in os.environ.items()
             if k != "JAX_COMPILATION_CACHE_DIR"} | {"JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"


_BLOCK_H5PY = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name == 'h5py' or name.startswith('h5py.'):\n"
    "            raise ImportError('h5py blocked')\n"
    "sys.meta_path.insert(0, Block())\n")


def _python(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))


def test_import_without_h5py():
    out = _python(_BLOCK_H5PY + "import oceananigans_tpu\nprint('ok')")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_hdf5_writer_without_h5py_raises_import_error(tmp_path):
    code = _BLOCK_H5PY + (
        "from oceananigans_tpu import output\n"
        "try:\n"
        "    output._h5py()\n"
        "except ImportError as e:\n"
        "    print('ImportError:', e)\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ImportError: HDF5")


def test_models_take_no_kernel_options():
    """One path per platform: no constructor selects a kernel."""
    import inspect

    from oceananigans_tpu.models import (
        HydrostaticFreeSurfaceModel, NonhydrostaticModel, ShallowWaterModel,
    )
    for cls in (NonhydrostaticModel, HydrostaticFreeSurfaceModel,
                ShallowWaterModel):
        params = inspect.signature(cls).parameters
        assert not [p for p in params if "fused" in p or "kernel" in p]


def test_chip_smoke_fails_without_gpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole smoke run on the card, from a child process."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200,
                         env={k: v for k, v in os.environ.items()
                              if k != "JAX_PLATFORMS"})
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1].startswith('{"ok": true')
