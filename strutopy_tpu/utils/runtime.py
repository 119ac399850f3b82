"""Process-level JAX set-up shared by the entry points.

``enable_compile_cache`` places the persistent compilation cache;
``require_gpu`` refuses to measure anywhere but on a CUDA GPU;
``gpu_card`` names the card as ``nvidia-smi`` reports it.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return that directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads
    it itself) and nothing is set in code.  Otherwise the cache goes to
    ``<repo>/.jax_cache``: a fixed path, since a cache whose directory
    moves between runs never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def require_gpu(what: str) -> None:
    """Exit with a message unless JAX's default backend is a CUDA GPU.

    There is no CPU fallback: a number measured on the host would be
    reported under a device's name."""
    import jax

    try:
        backend = jax.default_backend()
    except (RuntimeError, AssertionError) as e:
        # jax_platforms="cuda" without a usable card fails in backend
        # initialization (an AssertionError in some JAX versions)
        raise SystemExit(f"{what} needs a CUDA GPU; JAX could not start one: {e!r}")
    if backend != "gpu":
        raise SystemExit(
            f"{what} needs a CUDA GPU; JAX found no GPU (default backend "
            f"{backend!r})"
        )


def gpu_card() -> str:
    """``name, power.limit`` of the first card, from ``nvidia-smi``.

    Runs in a child process that does not import JAX, so it never
    competes with this process for the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()
