#!/usr/bin/env python
"""Headline benchmark: one JSON line.

Methodology follows the reference's benchmark executables: throughput =
numel * runs / seconds with a host verification pass
(`src/benchmarks/clo_sort_bench.c:233-235`, `clo_scan_bench.c:278`).

Headline: the Blelloch scan (three phases, the third a Triton kernel) of
256M uint32 values into uint64 sums — the reference's own scan benchmark
shape, uint -> ulong (`clo_scan_bench.c:26-31`). `vs_baseline` is the
speedup over XLA's `jnp.cumsum` on the same card and data. The row names
the device, and the run refuses to measure anywhere but a GPU.

Prints exactly ONE JSON line on stdout.
"""

import json
import sys


def main():
    import numpy as np
    import jax
    jax.config.update("jax_enable_x64", True)
    from cl_ops_tpu.bench import common
    from cl_ops_tpu.bench.roofline import measured_copy_gbs, roofline_row
    from cl_ops_tpu.ops.scan import scan_new
    from cl_ops_tpu.ops.scan.kernels import scan_least_bytes
    from cl_ops_tpu.utils.platform import enable_compile_cache

    common.require_gpu("bench.py")
    enable_compile_cache()
    n, runs = 1 << 28, 10
    x_host = np.random.default_rng(7).integers(0, 2 ** 32, n,
                                               dtype=np.uint32)
    x = jax.device_put(x_host)
    ours = scan_new("blelloch", elem_dtype="uint", sum_dtype="ulong")
    base = scan_new("xla", elem_dtype="uint", sum_dtype="ulong")
    out = np.asarray(ours.scan_with_device_data(x))
    want = np.cumsum(x_host, dtype=np.uint64) - x_host
    assert np.array_equal(out, want), "scan verification failed"
    dt = common.time_async(ours.scan_with_device_data, (x,), runs) / runs
    dt_xla = common.time_async(base.scan_with_device_data, (x,), runs) / runs
    row = {"metric": "blelloch_scan_u32_u64_256M",
           "value": round(n / dt / 1e6, 1), "unit": "Melems/s",
           "vs_baseline": round(dt_xla / dt, 4)}
    row.update(roofline_row(scan_least_bytes(n, np.uint32, np.uint64), dt))
    row["copy_gb_s"] = round(measured_copy_gbs(), 2)
    row.update(common.device_fields())
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
