"""Benchmark harness shared pieces.

Parity with the reference's bench common module (`src/benchmarks/clo_bench.c`):
typed random fill (`clo_bench_rand`, clo_bench.c:67-142), typed comparator
(`clo_bench_compare`, clo_bench.c:31-65), plus the throughput formula, TSV
output shared by all three CLIs (`clo_sort_bench.c:233-249`), the timing
helper and the device fields every benchmark row carries.

Timing: host clock around calls that end in `jax.block_until_ready` (JAX
returns before the device finishes, so a timing without it measures the
enqueue).
"""

from __future__ import annotations

import time

import numpy as np


def rand_array(dtype, n: int, seed: int = 0) -> np.ndarray:
    """Typed random values covering the type's range (clo_bench_rand parity).

    Integer types draw uniformly over their full range; floats draw normal
    scaled values like the reference's g_rand_double ranges.
    """
    rng = np.random.RandomState(seed)
    dt = np.dtype(dtype)
    if dt.kind in "ui" and dt.itemsize == 8:
        # Compose 64-bit draws from two 32-bit halves: a single randint is
        # capped below 2^63, which would never set the top bit of u64 data
        # (leaving the high-limb sign-flip path untested/unbenchmarked).
        lo = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64)
        hi = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64)
        return (lo | (hi << np.uint64(32))).view(np.uint64).astype(dt) \
            if dt.kind == "u" else (lo | (hi << np.uint64(32))).view(np.int64)
    if dt.kind == "u":
        bits = 8 * dt.itemsize
        return rng.randint(0, 2 ** bits, size=n,
                           dtype=np.uint64).astype(dt)
    if dt.kind == "i":
        lim = 2 ** (8 * dt.itemsize - 1)
        return rng.randint(-lim, lim, size=n, dtype=np.int64).astype(dt)
    return (rng.randn(n) * 128).astype(dt)


def compare_values(a, b) -> int:
    """Three-way compare (clo_bench_compare parity)."""
    return int(a > b) - int(a < b)


def time_async(fn, args, runs: int) -> float:
    """Seconds for `runs` queued calls of fn(*args), after one warm-up
    (compile) call; the clock stops when the last result is ready."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def throughput_m(numel: int, runs: int, seconds: float) -> float:
    """Mkeys/s | MValues/s: 1e-6 * numel * runs / seconds
    (clo_sort_bench.c:233-235)."""
    return 1e-6 * numel * runs / seconds


def write_tsv(path: str, rows: list[dict]) -> None:
    """TSV output like the reference benches (clo_sort_bench.c:239-249)."""
    if not rows:
        return
    cols = list(rows[0].keys())
    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        for r in rows:
            f.write("\t".join(str(r[c]) for c in cols) + "\n")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them, from a
    child process that stays off JAX ("not available" without one)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


def device_fields() -> dict:
    """platform, device_kind, device count and power limit: the fields
    every benchmark row names its device by."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "power_limit": power_limit()}


def require_gpu(what: str) -> None:
    """Measurements are device metrics: refuse to take them off the GPU."""
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"{what}: full-scale measurement needs a GPU "
                         f"(found platform {platform!r})")
