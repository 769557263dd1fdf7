"""Backend helpers: the platform a computation targets, the CPU switch, the
persistent compile cache, and the GPU checks of the measurement scripts.

Tests and CPU tooling select the CPU through `JAX_PLATFORMS=cpu` before JAX
is imported; `force_cpu()` does the same from inside a process that has
imported JAX but not yet computed anything.
"""

from __future__ import annotations

import os
import subprocess

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def force_cpu(virtual_devices: int | None = None) -> None:
    if virtual_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{virtual_devices}"
            ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


def target_platform() -> str:
    """Platform ("cpu", "gpu", ...) that a computation traced now will run
    on: the device set by `jax.default_device(...)` if any, else the
    default backend. Read at trace time to pick kernels; the setting is part
    of jit's cache key, so switching it retraces."""
    import jax

    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and is left
    alone. Otherwise the cache lives in `<checkout>/.jax_cache`: a fixed
    path, since the path is part of the cache key.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first GPU device, or SystemExit with a message when JAX finds
    none. Measurement paths call this: they never fall back to the CPU."""
    import jax

    devs = jax.devices()
    if not devs or devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {[str(d) for d in devs]}")
    return devs[0]


def nvidia_smi_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W". Runs as a child process that stays
    off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
