"""Backend selection for the package's Pallas kernels, and its compile cache.

The reference selects an OpenCL device at runtime (interactive menu,
`src/benchmarks/clo_sort_bench.c:148-149`). Here JAX picks the backend, and
the one decision left is how a Pallas kernel runs on it: compiled through
Triton on the GPU, or interpreted on the CPU (the test suite — the
reference's tests likewise ran on "any OpenCL device",
`src/tests/test_rng.c:65`). No other platform has a route, and none is
guessed at.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax


def pallas_mode() -> str:
    """How a Pallas kernel runs on the default backend.

    "triton" on the GPU (every kernel names `backend="triton"`),
    "interpret" on the CPU. Any other platform is an error: a kernel must
    never fall back to the interpreter on an accelerator unnoticed.
    """
    platform = jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "interpret"
    raise RuntimeError(
        f"no Pallas route for platform {platform!r}: kernels run compiled "
        "through Triton on a GPU or interpreted on the CPU")


def checkout_root() -> Path:
    """The directory that holds the `cl_ops_tpu` package."""
    return Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is honoured as it is (JAX reads
    it itself). Otherwise the cache is the fixed `.jax_cache` under the
    checkout root, so every process of one checkout shares it.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(checkout_root() / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
