"""Persistent-compile-cache setup.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
module sets no other directory. Otherwise the cache lives at the fixed path
``<repo>/.jax_cache/<cpu-fingerprint>-<platform>``.

The fingerprint is there because XLA:CPU cache entries embed AOT machine
code compiled for the exact CPU feature set of the compiling host, and the
cache key does NOT include those features: a cache directory carried to a
machine with a different CPU gets *loaded and executed*, producing "machine
type doesn't match" warnings and SIGILL/segfault crashes. Scoping the
directory by a hash of the host's CPU flags makes a moved cache simply miss.
"""
from __future__ import annotations

import hashlib
import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def machine_fingerprint() -> str:
    """Short stable hash of the host CPU's feature flags AND model name.

    The flags line alone is not enough: XLA derives per-microarchitecture
    tuning features (e.g. ``prefer-no-scatter``) from the CPU *model*, so
    two hosts with identical ISA flags can produce mutually-incompatible
    AOT entries ('Machine type used for XLA:CPU compilation doesn't match'
    loader errors)."""
    src = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features", "model name")):
                    src += line
                    if src.count("\n") >= 2:
                        break
    except OSError:
        pass
    if not src:
        import platform
        src = platform.processor() + platform.machine()
    return hashlib.sha1(src.encode()).hexdigest()[:12]


def cache_dir(base_dir: str | None = None, platform: str = "default") -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` when set, else
    ``<base>/.jax_cache/<cpu-fingerprint>-<platform>`` (base defaults to the
    repository root). The platform tag keeps processes pinned to different
    backends in separate directories."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    if base_dir is None:
        base_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tag = machine_fingerprint() + "-" + str(platform).replace(",", "_")
    return os.path.join(base_dir, ".jax_cache", tag)


def setup_cache(base_dir: str | None = None,
                min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at ``cache_dir`` and return
    the directory. With the environment variable set, JAX has already taken
    it as its cache directory and only the minimum compile time is set."""
    import jax
    platform = getattr(jax.config, "jax_platforms", None) or "default"
    path = cache_dir(base_dir, platform)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
