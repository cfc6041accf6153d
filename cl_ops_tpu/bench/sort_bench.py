"""Sort benchmark CLI — parity with clo_sort_bench.

Mirrors the reference CLI surface (`src/benchmarks/clo_sort_bench.c:49-80`):
algorithm, algorithm options, runs, element type, size sweep 2^minpo2..
2^maxpo2, RNG seed, TSV output, and a per-run host verification pass
(`clo_sort_bench.c:216-227`). The lws/device/compiler-opts flags map to
their analogs here: options ride --alg-options; the device is the default
JAX device.

Usage:
  python -m cl_ops_tpu.bench.sort_bench -a abitonic -r 5 --maxpo2 20
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", "--algorithm", default="abitonic",
                   help="sort impl name (default abitonic)")
    p.add_argument("-o", "--alg-options", default=None,
                   help='impl options "k1=v1,k2=v2" (ref option strings)')
    p.add_argument("-r", "--runs", type=int, default=1)
    p.add_argument("-t", "--type", dest="elem_type", default="uint",
                   help="element type name (default uint)")
    p.add_argument("--minpo2", type=int, default=4)
    p.add_argument("-n", "--maxpo2", type=int, default=24,
                   help="max size = 2^maxpo2 (ref default 24)")
    p.add_argument("-s", "--rng-seed", type=int, default=0)
    p.add_argument("--out", default=None, help="TSV output file")
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--kv", action="store_true",
                   help="key-value sort (carries an i32 payload)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from cl_ops_tpu.bench import common
    from cl_ops_tpu.ops import sort as sort_mod

    sorter = sort_mod.sort_new(args.algorithm, args.alg_options,
                               elem_dtype=args.elem_type)
    # roofline accounting against the least bytes a sort moves (a device
    # metric: GPU runs only)
    traffic = None
    if jax.devices()[0].platform == "gpu":
        from cl_ops_tpu.ops.exec.psort import sort_traffic_bytes
        from cl_ops_tpu.ops.sort import keys as keymod
        ncols = keymod.num_limbs(sorter.elem_dtype) + (1 if args.kv else 0)
        traffic = lambda nn: sort_traffic_bytes(nn, ncols)  # noqa: E731
    rows = []
    print(f"# algorithm: {args.algorithm}  type: {args.elem_type}  "
          f"runs: {args.runs}")
    print(f"{'N':>12} {'Mkeys/s':>12} {'ms/run':>10} {'GB/s':>8} "
          f"{'roof':>6}  check")
    for po2 in range(args.minpo2, args.maxpo2 + 1):
        n = 1 << po2
        host = common.rand_array(sorter.elem_dtype, n,
                                 args.rng_seed + po2)
        dev = jax.device_put(host)
        if args.kv:
            vals = jax.device_put(np.arange(n, dtype=np.int32))
            fn, fargs = sorter.sort_with_device_data, (dev, vals)
        else:
            fn, fargs = sorter.sort_with_device_data, (dev,)
        secs = common.time_async(fn, fargs, args.runs)
        mkeys = common.throughput_m(n, args.runs, secs)
        if args.no_check:
            check = "skipped"
        else:
            out = fn(*fargs)
            out = out[0] if isinstance(out, tuple) else out
            outh = np.asarray(out)
            if sorter.elem_dtype.kind == "f":
                # NaN-aware: sorted floats must equal np.sort bit-for-bit
                # modulo NaN position (keys.py orders NaN high, like np.sort).
                ref = np.sort(host)
                ok = bool(np.array_equal(outh, ref, equal_nan=True))
            else:
                ok = bool(np.all(np.diff(outh) >= 0))
            check = "ok" if ok else "FAILED"
        row = {"n": n, "mkeys_s": round(mkeys, 2),
               "ms_per_run": round(secs / args.runs * 1e3, 3)}
        if traffic is not None:
            from cl_ops_tpu.bench.roofline import roofline_row
            row.update(roofline_row(traffic(n), secs / args.runs))
        row["check"] = check
        print(f"{n:>12} {mkeys:>12.1f} {secs / args.runs * 1e3:>10.2f} "
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
