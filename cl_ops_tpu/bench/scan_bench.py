"""Scan benchmark CLI — parity with clo_scan_bench.

Mirrors the reference CLI (`src/benchmarks/clo_scan_bench.c:53-92`): impl
name + options, runs, element/sum types, size sweep init_elems * 2^1 ..
init_elems * 2^num_doub (defaults 4 x 2^24), serial-CPU verification with
overflow detection against the sum type's max (`clo_scan_bench.c:246-271`),
--no-check, MValues/s reporting, TSV output. Input values are kept < 128 to
delay overflow exactly like the reference (`clo_scan_bench.c:219-224`).
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", "--algorithm", default="blelloch")
    p.add_argument("-o", "--alg-options", default=None)
    p.add_argument("-r", "--runs", type=int, default=1)
    p.add_argument("-t", "--type", dest="elem_type", default="uint")
    p.add_argument("--sum-type", default=None,
                   help="accumulator type (default: widening rule)")
    p.add_argument("-i", "--init-elems", type=int, default=4)
    p.add_argument("-n", "--num-doub", type=int, default=24)
    p.add_argument("--min-doub", type=int, default=1)
    p.add_argument("-s", "--rng-seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--no-check", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from cl_ops_tpu.bench import common
    from cl_ops_tpu.ops import scan as scan_mod

    s = scan_mod.scan_new(args.algorithm, args.alg_options,
                          elem_dtype=args.elem_type,
                          sum_dtype=args.sum_type)
    # roofline accounting (a device metric: GPU runs only)
    traffic = None
    if args.algorithm == "blelloch" and jax.devices()[0].platform == "gpu":
        from cl_ops_tpu.ops.scan.kernels import scan_least_bytes
        traffic = lambda nn: scan_least_bytes(  # noqa: E731
            nn, s.elem_dtype, s.sum_dtype)
    rows = []
    print(f"# algorithm: {args.algorithm}  type: {args.elem_type} -> "
          f"{s.sum_dtype}  runs: {args.runs}")
    print(f"{'N':>12} {'MValues/s':>12} {'ms/run':>10} {'GB/s':>8} "
          f"{'roof':>6}  check")
    rng = np.random.RandomState(args.rng_seed)
    for d in range(args.min_doub, args.num_doub + 1):
        n = args.init_elems * (1 << d)
        # values < 128 to delay overflow (clo_scan_bench.c:219-224)
        if np.dtype(s.elem_dtype).kind in "iu":
            host = rng.randint(0, 128, size=n).astype(s.elem_dtype)
        else:
            host = rng.rand(n).astype(s.elem_dtype)
        dev = jax.device_put(host)
        secs = common.time_async(s.scan_with_device_data, (dev,), args.runs)
        mvals = common.throughput_m(n, args.runs, secs)
        if args.no_check:
            check = "skipped"
        else:
            out = np.asarray(jax.block_until_ready(
                s.scan_with_device_data(dev)))
            acc = np.cumsum(host.astype(s.sum_dtype))
            expect = acc - host.astype(s.sum_dtype)
            sd = np.dtype(s.sum_dtype)
            if sd.kind in "iu":
                # overflow detection parity (clo_scan_bench.c:246-271)
                true_sum = np.cumsum(host.astype(np.float64))
                if true_sum[-1] > np.iinfo(sd).max:
                    check = "overflow"
                else:
                    check = "ok" if np.array_equal(out, expect) else "FAILED"
            else:
                check = ("ok" if np.allclose(out, expect, rtol=1e-5)
                         else "FAILED")
        row = {"n": n, "mvalues_s": round(mvals, 2),
               "ms_per_run": round(secs / args.runs * 1e3, 3)}
        if traffic is not None:
            from cl_ops_tpu.bench.roofline import roofline_row
            row.update(roofline_row(traffic(n), secs / args.runs))
        row["check"] = check
        print(f"{n:>12} {mvals:>12.1f} {secs / args.runs * 1e3:>10.2f} "
              f"{row.get('gb_s', 0):>8.1f} {row.get('roofline_frac', 0):>6.3f}"
              f"  {check}")
        rows.append(row)
        if check == "FAILED":
            print("verification FAILED", file=sys.stderr)
            return 1
    if args.out:
        common.write_tsv(args.out, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
