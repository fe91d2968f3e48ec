"""Platform selection helpers.

Call exactly one of use_cpu()/use_gpu() at process start, before the first
backend use: JAX reads ``jax_platforms`` once, when it initializes its
backends.
"""

from __future__ import annotations

import os

import jax

# Fixed in-checkout default for the persistent compile cache: the cache
# path is part of what makes a later process find an entry, so it never
# depends on a temp name, a PID or the time.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def use_cpu(num_devices: int | None = None, x64: bool = True) -> None:
    """Run on host CPU, optionally with N virtual devices (mesh emulation)."""
    jax.config.update("jax_platforms", "cpu")
    if num_devices is not None:
        jax.config.update("jax_num_cpu_devices", num_devices)
    if x64:
        ensure_x64()


def use_gpu(x64: bool = False) -> None:
    """Run on the NVIDIA GPU backend; raise if no GPU device is present.

    Keeps the CPU platform registered as secondary so host-side problem-data
    evaluation (quadrature loads, exact solutions) can pin to it
    (models/problems._host_device): those are many tiny batches that would
    otherwise each pay a kernel launch and a host-device copy.
    """
    jax.config.update("jax_platforms", "cuda,cpu")
    try:
        gpus = jax.devices("gpu")
    except RuntimeError as e:
        raise RuntimeError(
            "no GPU device found (jax_platforms='cuda,cpu'); run with "
            "--device cpu to use the host instead"
        ) from e
    if not gpus:
        raise RuntimeError("no GPU device found")
    enable_compile_cache()
    if x64:
        ensure_x64()


def ensure_x64() -> None:
    jax.config.update("jax_enable_x64", True)


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` per line). A card set below its maximum power
    runs slower under load, so every timing is reported beside this."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else the fixed in-checkout
    ``.jax_cache`` directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Persist compiled executables across processes; returns the directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other path is set here. Full-solve graphs at the large configurations
    take tens of seconds to compile; the cache makes repeat runs at the same
    shapes start quickly.
    """
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    return path
