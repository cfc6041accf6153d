"""Memory-bandwidth roofline accounting for the benchmark harness.

Every bench row that has a bytes model reports, next to rows/s:

  * bytes_moved — the least device-memory traffic the operation needs,
    computed host-side from its shapes by the model beside the operator;
  * gb_s = bytes_moved / measured seconds;
  * roofline_frac = gb_s over the card's PUBLISHED peak bandwidth, looked
    up by `device_kind`. A device not in the table is an error, never a
    default.

`measured_copy_gbs` reports what a large plain copy reaches on the same
card, to be printed beside the peak — never used as the denominator.
"""

from __future__ import annotations

import time

# Published peak device-memory bandwidth, bytes/s, by jax device_kind.
PEAK_BYTES_PER_S = {
    # NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bytes_per_s(device_kind: str | None = None) -> float:
    """Published peak bandwidth of the device (default: jax.devices()[0])."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(f"no published peak bandwidth for device "
                       f"{device_kind!r}; add it to PEAK_BYTES_PER_S with "
                       f"its source") from None


def measured_copy_gbs(mb: int = 1024, runs: int = 5) -> float:
    """What a plain `a + 1` over an mb-MiB i32 buffer reaches, in GB/s
    (read + write), best of `runs` calls each ending in
    block_until_ready."""
    import jax
    import jax.numpy as jnp
    n = mb * (1 << 20) // 4
    x = jnp.arange(n, dtype=jnp.int32)
    f = jax.jit(lambda a: a + 1)
    jax.block_until_ready(f(x))
    best = 0.0
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        best = max(best, 2.0 * n * 4 / (time.perf_counter() - t0) / 1e9)
    return best


def roofline_row(bytes_moved: int, seconds: float,
                 device_kind: str | None = None) -> dict:
    """gb_s + roofline_frac (against the published peak) for a bench row."""
    gbs = bytes_moved / seconds / 1e9
    peak = peak_bytes_per_s(device_kind) / 1e9
    return {"gb_s": round(gbs, 2), "roofline_frac": round(gbs / peak, 4),
            "peak_gb_s": peak}
