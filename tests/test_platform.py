"""Platform selection, the compile-cache location, and the structure of the
traced solve: no CPU fallback when a GPU is asked for, the cache directory
from ``JAX_COMPILATION_CACHE_DIR`` or one fixed path inside the checkout,
and no Pallas kernel or unpinned f32 matrix product in the operators."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spacetime.fem import P1System, domain_mesh, refine_hierarchy
from spacetime.fem.timegrid import graded_time_grid, uniform_time_grid
from spacetime.models import get_problem
from spacetime.solver.heateq import HeatSolver
from spacetime.utils.jaxpr_audit import primitive_names, unpinned_f32_dots
from spacetime.utils.platform import (
    DEFAULT_CACHE_DIR,
    compile_cache_dir,
    device_record,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code_or_args, extra_env=None, timeout=300):
    """Run a fresh interpreter in the checkout with no GPU visible."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra_env or {})
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else list(code_or_args))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


# ----------------------------------------------------------- platform


def test_use_gpu_raises_without_gpu():
    r = _python("from spacetime.utils.platform import use_gpu; use_gpu()")
    assert r.returncode != 0
    assert "no GPU device found" in r.stderr


@pytest.mark.parametrize("device", ["gpu", "default"])
def test_run_device_gpu_does_not_fall_back(device):
    r = _python(["-m", "spacetime.run", "--backend", "jax", "--device",
                 device, "--space-n", "4", "--time-levels", "2", "--out",
                 ""])
    assert r.returncode != 0
    assert "no GPU device found" in r.stderr
    assert "space-time DoF" not in r.stdout  # never reached the solve


def test_oracle_default_runs_on_host():
    r = _python(["-m", "spacetime.run", "--backend", "oracle", "--space-n",
                 "4", "--time-levels", "2", "--out", ""])
    assert r.returncode == 0, r.stderr
    assert "iterations" in r.stdout


def test_device_record_reports_jax_devices():
    rec = device_record()
    assert rec == {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


# ------------------------------------------------------- compile cache


def test_cache_dir_honors_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == DEFAULT_CACHE_DIR
    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


_PRINT_CACHE = (
    "import jax; from spacetime.utils.platform import enable_compile_cache;"
    "print(enable_compile_cache()); print(jax.config.jax_compilation_cache_dir)"
)


def test_enable_compile_cache_uses_env_dir(tmp_path):
    r = _python(_PRINT_CACHE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_enable_compile_cache_default_dir():
    r = _python(_PRINT_CACHE)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [DEFAULT_CACHE_DIR, DEFAULT_CACHE_DIR]


# ------------------------------------------------------- traced solve


def _solver(problem, n, inner, refine=0, extra=0):
    pr = get_problem(problem)
    mesh = domain_mesh(pr.domain, pr.dim, n)
    if refine:
        mesh = refine_hierarchy(mesh, refine)
    system = P1System.from_problem(pr, mesh)
    grid = graded_time_grid(3, extra) if extra else uniform_time_grid(3)
    return HeatSolver(pr, system, grid, dtype=jnp.float32, inner=inner)


CONFIGS = {
    "2d-mg": ("smooth2d", 16, "mg", 0, 0),
    "3d-mg": ("smooth3d", 8, "mg", 0, 0),
    "weighted-mg": ("varcoef2d", 16, "mg", 0, 0),
    "graded-mg": ("singular2d", 16, "mg", 0, 2),
    "nested-mg": ("lshape2d", 4, "mg", 2, 0),
    "sa-amg": ("lshape2d", 16, "amg", 0, 0),
    "dense": ("smooth2d", 8, "dense", 0, 0),
}


@pytest.mark.parametrize("op", ["apply_S", "apply_KX"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_operator_is_plain_xla(config, op):
    s = _solver(*CONFIGS[config])
    p = s.params_for(jnp.float32)
    U = jax.ShapeDtypeStruct((s.N + 1,) + s.gs, jnp.float32)
    jaxpr = jax.make_jaxpr(lambda u, pp: getattr(s, op)(u, pp))(U, p)
    names = primitive_names(jaxpr)
    assert not any("pallas" in n for n in names), names
    assert unpinned_f32_dots(jaxpr) == []


def test_audit_flags_unpinned_f32_dot():
    a = np.ones((4, 4), np.float32)
    loose = jax.make_jaxpr(lambda x: jnp.dot(x, x))(a)
    pinned = jax.make_jaxpr(lambda x: jnp.dot(
        x, x, precision=jax.lax.Precision.HIGHEST))(a)
    f64 = jax.make_jaxpr(lambda x: jnp.dot(x, x))(a.astype(np.float64))
    nested = jax.make_jaxpr(lambda x: jax.lax.fori_loop(
        0, 2, lambda i, y: jnp.dot(y, x), x))(a)
    assert len(unpinned_f32_dots(loose)) == 1
    assert unpinned_f32_dots(pinned) == []
    assert unpinned_f32_dots(f64) == []
    assert len(unpinned_f32_dots(nested)) == 1
    assert {"dot_general", "scan"} <= primitive_names(nested)
