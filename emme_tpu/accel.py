"""What each platform prefers, decided in one place.

The program runs on the CPU (tests, small cases) and on NVIDIA GPUs.  Every
default that depends on the machine -- the Newton loop, the PIC deposit,
whether a hand-written kernel may run compiled -- is read from here, with
the platform passed in explicitly or taken from the devices the computation
runs on.  A platform outside ``PLATFORMS`` is an error, not a default.
"""

from __future__ import annotations

import os
import pathlib

import jax

PLATFORMS = ("cpu", "gpu")

# the checkout's own compile-cache directory (listed in .gitignore)
CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def current(devices=None) -> str:
    """Platform of ``devices`` (a device list, a Mesh, or None for the
    default devices)."""
    if devices is None:
        devices = jax.devices()
    elif hasattr(devices, "devices"):      # a jax.sharding.Mesh
        devices = devices.devices.flat
    name = next(iter(devices)).platform
    if name not in PLATFORMS:
        raise RuntimeError(f"unsupported platform {name!r}; this program "
                           f"runs on {' or '.join(PLATFORMS)}")
    return name


def require(platform: str):
    """Fail at once unless JAX's default devices are on ``platform``: a run
    that asked for the card never falls back to the CPU."""
    try:
        found = jax.devices()[0].platform
    except Exception as e:      # JAX raises a bare error with no backend
        raise RuntimeError(f"no {platform} device available "
                           f"({type(e).__name__}: {e})") from e
    if found != platform:
        raise RuntimeError(f"asked for {platform!r} but JAX runs on "
                           f"{found!r}")


def newton_loop(platform: str) -> str:
    """Default Newton driver: the traced ``lax.while_loop`` (one host sync
    per solve) on a GPU, where a per-step sync idles the card; the
    host-driven loop on the CPU, where it costs nothing and eases
    debugging."""
    return "device" if platform == "gpu" else "host"


def pic_deposit(platform: str) -> str:
    """Default PIC charge deposit: the one-hot matrix product on a GPU,
    where ``segment_sum``'s atomic scatter-add into ~1e3 cells from ~1e6
    markers serialises on contention (measured slower on an H100;
    CHANGES.md); ``segment_sum`` on the CPU."""
    return "matmul" if platform == "gpu" else "segment"


def fused_assembly(platform: str, real_dtype) -> bool:
    """Whether the f32 assembly runs the fused kappa kernel
    (``ops/pallas_kappa.py``) by default: only where it runs compiled."""
    return platform == "gpu" and jax.numpy.dtype(real_dtype).name == "float32"


def require_kernel_route(platform: str | None = None):
    """Raise unless a hand-written kernel can run compiled on ``platform``.
    Kernels run in the Pallas interpreter only when the caller passes
    ``interpret=True``."""
    platform = platform or current()
    if platform != "gpu":
        raise RuntimeError(
            f"the fused kernel has no compiled route on {platform!r}; it "
            "runs compiled on a GPU, or pass interpret=True to run it in the "
            "Pallas interpreter")


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Turn on JAX's persistent compile cache.  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing else is
    set; otherwise the cache is the checkout's fixed ``.jax_cache``.
    Returns the directory in use."""
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
