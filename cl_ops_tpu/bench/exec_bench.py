"""Query-operator benchmark CLI — the north-star operator configs.

Covers the BASELINE.json single-chip configs (scaled by --scale):
  filter     — prefix-sum filter + compaction, 10% selectivity
  aggregate  — GROUP BY sum over hashed keys
  join       — dim-table build + fact probe (Zipf-skewed keys available)
  expand / window / topk / distinct — the other query operators

Usage:
  python -m cl_ops_tpu.bench.exec_bench --op filter -n 26 -r 5
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--op", default="filter",
                   choices=["filter", "aggregate", "join", "expand",
                            "window", "topk", "distinct"])
    p.add_argument("--k", type=int, default=1024,
                   help="topk: LIMIT k")
    p.add_argument("--sorted-output", action="store_true",
                   help="window: skip the restore sort (the consumer-"
                        "re-sorts-anyway fusion form)")
    p.add_argument("--dup", type=int, default=4,
                   help="expand: matches per probe (build dups)")
    p.add_argument("--sparse", action="store_true",
                   help="expand: stride probes across the whole build")
    p.add_argument("-n", "--log2n", type=int, default=24,
                   help="rows = 2^log2n (default 24)")
    p.add_argument("-r", "--runs", type=int, default=5)
    p.add_argument("--selectivity", type=float, default=0.10)
    p.add_argument("--groups", type=int, default=1 << 20)
    p.add_argument("--dim-log2", type=int, default=20,
                   help="join build side = 2^dim_log2 rows")
    p.add_argument("--zipf", type=float, default=0.0,
                   help="Zipf exponent for join probe keys (0 = uniform)")
    p.add_argument("-s", "--rng-seed", type=int, default=0)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--probe-impl", default="auto",
                   choices=["auto", "direct", "merge"],
                   help="join/expand: probe strategy")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cl_ops_tpu.bench import common
    from cl_ops_tpu.ops import exec as ex
    from cl_ops_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    n = 1 << args.log2n
    rng = np.random.RandomState(args.rng_seed)

    if args.op == "filter":
        thresh = int(args.selectivity * (1 << 20))
        x = jnp.asarray(rng.randint(0, 1 << 20, size=n).astype(np.uint32))

        def pred(d):
            return d < jnp.uint32(thresh)

        # one predicate object: filter_compact jit-caches on its identity —
        # a fresh lambda per call would retrace every iteration
        fn = lambda v: ex.filter_compact(v, pred)  # noqa: E731
        secs = common.time_async(fn, (x,), args.runs)
        if not args.no_check:
            count, packed = fn(x)
            host = np.asarray(x)
            keep = host[host < thresh]
            assert int(count) == len(keep)
            assert np.array_equal(np.asarray(packed)[:len(keep)], keep)
    elif args.op == "aggregate":
        keys = jnp.asarray(rng.randint(0, args.groups, size=n)
                           .astype(np.uint32))
        vals = jnp.asarray(rng.randint(0, 100, size=n).astype(np.int32))
        def fn(k, v):
            return ex.group_aggregate_sorted(k, v, num_groups=args.groups)
        secs = common.time_async(fn, (keys, vals), args.runs)
        if not args.no_check:
            gk, table, cnt = fn(keys, vals)
            gk, table = np.asarray(gk), np.asarray(table)
            hk, hv = np.asarray(keys), np.asarray(vals)
            probe = rng.randint(0, int(cnt), size=16)
            for i in probe:
                assert table[i] == hv[hk == gk[i]].sum()
    elif args.op == "expand":
        # full inner-join expansion: build side has `dup` rows per key, so
        # every probe emits `dup` (probe, value) pairs
        nd = 1 << args.dim_log2
        nkeys = max(nd // args.dup, 1)
        dim_keys = (np.arange(nd, dtype=np.uint32) % nkeys)
        rng.shuffle(dim_keys)
        dim_vals = np.arange(nd, dtype=np.int32)
        if args.sparse:
            # every probe hits once, matches striding the whole build
            stride = max(nkeys // n, 1)
            probe = ((np.arange(n, dtype=np.int64) * stride) % nkeys
                     ).astype(np.uint32)
            capacity = args.dup * n
        else:
            probe = rng.randint(0, nkeys, size=n).astype(np.uint32)
            capacity = args.dup * n
        from cl_ops_tpu.ops.sort import sort_new
        sorter = sort_new("xla", elem_dtype="uint")
        sdk, sdv = sorter.sort_with_device_data(jnp.asarray(dim_keys),
                                                jnp.asarray(dim_vals))
        fn = lambda p: ex.hash_join_expand(  # noqa: E731
            sdk, sdv, p, capacity=capacity, build_sorted=True,
            probe_impl=args.probe_impl)
        secs = common.time_async(fn, (jnp.asarray(probe),), args.runs)
        if not args.no_check:
            # FULL exact oracle (not a sample): random probes with
            # replacement duplicate keys heavily.
            total, pidx, vals = fn(jnp.asarray(probe))
            assert int(total) == capacity
            pidx, vals = np.asarray(pidx), np.asarray(vals)
            order = np.argsort(probe, kind="stable")
            np.testing.assert_array_equal(pidx, np.repeat(order, args.dup))
            assert nd % nkeys == 0, "exact check needs dup | 2^dim_log2"
            per_key = np.asarray(sdv).reshape(nkeys, args.dup)
            np.testing.assert_array_equal(
                vals, per_key[probe[order]].reshape(-1))
    elif args.op == "window":
        # sum + row_number OVER (PARTITION BY key ORDER BY o) — one
        # 4-column partition sort, two segmented scans, one restore sort
        # (skipped with --sorted-output)
        keys = jnp.asarray(rng.randint(0, args.groups, size=n)
                           .astype(np.uint32))
        order = jnp.asarray(rng.randint(0, 1 << 30, size=n)
                            .astype(np.uint32))
        vals = jnp.asarray(rng.randint(0, 100, size=n).astype(np.int32))
        so = args.sorted_output

        def fn(k, o, v):
            out = ex.window_cols(k, o, (v, None), ("sum", "row_number"),
                                 sorted_output=so)
            return (*out[0], out[1]) if so else out
        secs = common.time_async(fn, (keys, order, vals), args.runs)
        if not args.no_check:
            out = fn(keys, order, vals)
            (wsum, wrow), row_src = ((out[:2], out[2]) if so
                                     else (out, None))
            hk, ho, hv = (np.asarray(keys), np.asarray(order),
                          np.asarray(vals))
            wsum, wrow = np.asarray(wsum), np.asarray(wrow)
            if so:
                src = np.asarray(row_src)
            probe = rng.randint(0, n, size=8)
            for i in probe:
                # row i's partition, ordered the way the operator orders
                # it: (order, position) ascending
                ri = src[i] if so else i
                sel = np.flatnonzero(hk == hk[ri])
                sel = sel[np.lexsort((sel, ho[sel]))]
                r = int(np.flatnonzero(sel == ri)[0])
                assert wrow[i] == r + 1, (i, wrow[i], r + 1)
                assert wsum[i] == hv[sel[:r + 1]].sum()
    elif args.op == "topk":
        vals = jnp.asarray(rng.randint(0, 1 << 30, size=n)
                           .astype(np.uint32))
        pay = jnp.asarray(rng.randint(0, 1 << 30, size=n)
                          .astype(np.int32))
        fn = lambda v, p: ex.top_k(v, args.k, p)  # noqa: E731
        secs = common.time_async(fn, (vals, pay), args.runs)
        if not args.no_check:
            tv, tp = fn(vals, pay)
            hv = np.asarray(vals)
            idx = np.argsort(hv, kind="stable")[:args.k]
            np.testing.assert_array_equal(np.asarray(tv), hv[idx])
            np.testing.assert_array_equal(np.asarray(tp),
                                          np.asarray(pay)[idx])
    elif args.op == "distinct":
        keys = jnp.asarray(rng.randint(0, args.groups, size=n)
                           .astype(np.uint32))
        cap = 1 << (int(args.groups - 1).bit_length())
        fn = lambda kk: ex.distinct(kk, capacity=cap)  # noqa: E731
        secs = common.time_async(fn, (keys,), args.runs)
        if not args.no_check:
            uv, cnt = fn(keys)
            ref = np.unique(np.asarray(keys))
            assert int(cnt) == len(ref)
            np.testing.assert_array_equal(np.asarray(uv)[:len(ref)], ref)
    else:  # join
        nd = 1 << args.dim_log2
        dim_keys = np.arange(nd, dtype=np.uint32)
        rng.shuffle(dim_keys)
        dim_vals = (dim_keys * 7 + 1).astype(np.uint32)
        if args.zipf > 0:
            probe = (np.random.default_rng(args.rng_seed)
                     .zipf(args.zipf, size=n) % nd).astype(np.uint32)
        else:
            probe = rng.randint(0, nd, size=n).astype(np.uint32)
        dk, dv, pk = (jnp.asarray(dim_keys), jnp.asarray(dim_vals),
                      jnp.asarray(probe))
        from cl_ops_tpu.ops.sort import sort_new
        sorter = sort_new("xla", elem_dtype="uint")
        sdk, sdv = sorter.sort_with_device_data(dk, dv)
        fn = lambda p: ex.hash_join(sdk, sdv, p, build_sorted=True,  # noqa
                                    probe_impl=args.probe_impl)
        secs = common.time_async(fn, (pk,), args.runs)
        if not args.no_check:
            found, vals = fn(pk)
            assert bool(np.all(np.asarray(found)))
            samp = rng.randint(0, n, size=16)
            v = np.asarray(vals)
            for i in samp:
                assert v[i] == probe[i] * 7 + 1

    mrows = common.throughput_m(n, args.runs, secs)
    extra = ""
    if jax.devices()[0].platform == "gpu":
        # least bytes each composition moves (psort/probe models) over the
        # card's published peak (bench/roofline.py)
        from cl_ops_tpu.bench.roofline import roofline_row
        from cl_ops_tpu.ops.exec import psort
        from cl_ops_tpu.ops.exec.probe import search_traffic_bytes
        if args.op == "filter":
            bytes_moved = 4 * n + psort.sort_traffic_bytes(n, 2)
        elif args.op == "aggregate":
            # (key,val) sort + the boundary passes: prev-compare read,
            # is_new/end_rank prefix sums, the sum prefix sum, ends gathers
            bytes_moved = psort.sort_traffic_bytes(n, 2) + 6 * 4 * n
        elif args.op == "window":
            # 4-col partition sort (key, order, pos, measure) + flags read
            # + two segmented scans + the 3-col restore sort unless
            # --sorted-output
            bytes_moved = (psort.sort_traffic_bytes(n, 4) + 4 * n
                           + 2 * 3 * 4 * n)
            if not args.sorted_output:
                bytes_moved += psort.sort_traffic_bytes(n, 3)
        elif args.op == "topk":
            # mask build (4n read + n write) + KB=4 argmax/clear sweeps
            # over the mask; the candidate sort is negligible
            bytes_moved = 4 * n + n + 4 * 2 * n
        elif args.op == "distinct":
            # key-only sort + boundary passes
            bytes_moved = psort.sort_traffic_bytes(n, 1) + 4 * 4 * n
        elif args.op == "join":
            bytes_moved = search_traffic_bytes(n, 1, 1)
        else:  # expand: probe sort + 2 bound searches + the expansion
            cap = args.dup * n
            bytes_moved = (psort.sort_traffic_bytes(n, 2)
                           + 2 * search_traffic_bytes(n, 1, 1)
                           + search_traffic_bytes(cap, 1, 3) + 3 * 4 * cap)
        rr = roofline_row(bytes_moved, secs / args.runs)
        extra = (f"  [{rr['gb_s']:.1f} GB/s, {rr['roofline_frac']:.3f} of "
                 f"the published peak]")
    print(f"{args.op}: {n} rows x {args.runs} runs -> {mrows:.1f} Mrows/s "
          f"({secs / args.runs * 1e3:.2f} ms/run){extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
