#!/usr/bin/env python
"""All BASELINE.json benchmark configs at size, one JSON line each.

Configs (BASELINE.md):
  1. 1M-uint32 bitonic sort             -> abitonic Mkeys/s
  2. 16M uint64 KV radix-class sort     -> satradix KV Mpairs/s
  3. 64M-row prefix-sum filter @10%     -> filter_compact Mrows/s
  4. 256M-row / 1M-group hash aggregate -> group_aggregate_sorted Mrows/s
  5. distributed hash join              -> single-card 16M x 1M probe
     (the four-card form runs through `chip_smoke.py --chips 4`)
plus the composite rows 6-12 below.

Every line names its device (platform, device_kind, device count, power
limit) and, where a bytes model exists, carries achieved GB/s and the
fraction of the card's published peak (bench/roofline.py). Run on a GPU:
`python bench_all.py`; off the GPU a full-scale run refuses to measure.
Scale down for smoke tests: `python bench_all.py --scale 8` divides every
row count by 8; such a run may use the CPU, and its rows carry no device
metrics.
"""

import argparse
import json
import sys


def _timed(fn, args, runs):
    """Per-call seconds over `runs` calls, after a warm-up call."""
    from cl_ops_tpu.bench.common import time_async
    return time_async(fn, args, runs) / runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=1,
                    help="divide all row counts by this (smoke testing)")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--configs", default="1,2,3,4,5,6,7,8,9,10,11,12",
                    help="comma list of config numbers to run")
    args = ap.parse_args(argv)
    configs = {int(c) for c in args.configs.split(",")}
    import numpy as np
    import jax
    jax.config.update("jax_enable_x64", True)  # u64 keys in config 2
    import jax.numpy as jnp
    from cl_ops_tpu.bench import common
    from cl_ops_tpu.bench.roofline import roofline_row
    from cl_ops_tpu.ops import exec as ex
    from cl_ops_tpu.ops import sort as sort_mod
    from cl_ops_tpu.ops.exec import psort
    from cl_ops_tpu.ops.exec.probe import search_traffic_bytes
    from cl_ops_tpu.utils.platform import enable_compile_cache

    sc = args.scale
    if sc == 1:
        common.require_gpu("bench_all.py")
        enable_compile_cache()
    on_gpu = jax.devices()[0].platform == "gpu"
    device = common.device_fields()
    runs = args.runs

    def emit(metric, value, unit, seconds=None, bytes_moved=None):
        row = {"metric": metric, "value": value, "unit": unit}
        if on_gpu and seconds is not None and bytes_moved is not None:
            row.update(roofline_row(bytes_moved, seconds))
        row.update(device)
        print(json.dumps(row), flush=True)

    if 1 in configs:
        # 1. 1M u32 sort through the bitonic network (4 MB: it sits in
        # the 50 MB L2, so this row measures the cache, not HBM)
        n = (1 << 20) // sc
        x = jnp.asarray(common.rand_array(np.uint32, n, 1))
        s = sort_mod.sort_new("abitonic")
        dt = _timed(s.sort_with_device_data, (x,), runs)
        assert bool(np.all(np.diff(np.asarray(
            s.sort_with_device_data(x)).astype(np.int64)) >= 0))
        emit("sort_u32_1M", n / dt / 1e6, "Mkeys/s", dt,
             psort.sort_traffic_bytes(n, 1))

    if 2 in configs:
        # 2. 16M u64 KV sort (LSD radix)
        n = (1 << 24) // sc
        k64 = jnp.asarray(common.rand_array(np.uint64, n, 2))
        v32 = jnp.asarray(np.arange(n, dtype=np.int32))
        s64 = sort_mod.sort_new("satradix", elem_dtype="ulong")
        dt = _timed(s64.sort_with_device_data, (k64, v32), runs)
        ok, ov = s64.sort_with_device_data(k64, v32)
        okh = np.asarray(ok)
        assert bool(np.all(np.diff(okh.astype(np.float64)) >= 0) or
                    np.all(okh[:-1] <= okh[1:]))
        emit("sort_u64kv_16M", n / dt / 1e6, "Mpairs/s", dt,
             psort.sort_traffic_bytes(n, 3))

    if 3 in configs:
        # 3. 64M filter @10%
        n = (1 << 26) // sc
        thresh = int(0.10 * (1 << 20))
        xf = jnp.asarray(np.random.RandomState(3).randint(
            0, 1 << 20, size=n).astype(np.uint32))

        def pred(d):
            return d < jnp.uint32(thresh)

        fn = lambda v: ex.filter_compact(v, pred)  # noqa: E731
        dt = _timed(fn, (xf,), runs)
        cnt, _ = fn(xf)
        emit("filter_64M_sel10", n / dt / 1e6, "Mrows/s", dt,
             4 * n + psort.sort_traffic_bytes(n, 2))

    if 4 in configs:
        # 4. 256M rows / 1M groups aggregate
        n = (1 << 28) // sc
        groups = (1 << 20) // max(sc // 16, 1)
        ka = jnp.asarray(np.random.RandomState(4).randint(
            0, groups, size=n).astype(np.uint32))
        va = jnp.asarray(np.random.RandomState(5).randint(
            0, 100, size=n).astype(np.int32))

        def agg(k, v):
            return ex.group_aggregate_sorted(k, v, num_groups=groups)

        dt = _timed(agg, (ka, va), runs)
        # sort + boundary passes; the n-row ends-compaction sort (and its
        # sort_traffic_bytes(n, 1) term) is gone — searchsorted over the
        # running end count finds group ends (aggregate.py r4)
        emit("aggregate_256M_1Mgroups", n / dt / 1e6, "Mrows/s", dt,
             psort.sort_traffic_bytes(n, 2) + 6 * 4 * n)

    if 5 in configs:
        # 5. join probe 16M x 1M (single-chip stand-in for the dist config)
        m = (1 << 24) // sc
        nd = (1 << 20) // sc
        dim = np.arange(nd, dtype=np.uint32)
        np.random.RandomState(6).shuffle(dim)
        dimv = (dim * 7 + 1).astype(np.uint32)
        probe = jnp.asarray(np.random.RandomState(7).randint(
            0, nd, size=m).astype(np.uint32))
        sd = sort_mod.sort_new("xla")
        sdk, sdv = sd.sort_with_device_data(jnp.asarray(dim),
                                            jnp.asarray(dimv))
        jfn = lambda p: ex.hash_join(sdk, sdv, p, build_sorted=True)  # noqa
        dt = _timed(jfn, (probe,), runs)
        # auto strategy = direct: one binary search per probe
        emit("join_probe_16Mx1M", m / dt / 1e6, "Mrows/s", dt,
             search_traffic_bytes(m, 1, 1))
        # sorted_output sorts the probes first (consumers that re-sort or
        # gather via probe_rows — the aggregate-after-join shape)
        jfs = lambda p: ex.hash_join(sdk, sdv, p, build_sorted=True,  # noqa
                                     sorted_output=True)
        dts = _timed(jfs, (probe,), runs)
        emit("join_probe_16Mx1M_sorted", m / dts / 1e6, "Mrows/s", dts,
             psort.sort_traffic_bytes(m, 2) + search_traffic_bytes(m, 1, 1))
        # the sort-merge probe strategy on the same data
        jfm = lambda p: ex.hash_join(sdk, sdv, p, build_sorted=True,  # noqa
                                     probe_impl="merge")
        dtm = _timed(jfm, (probe,), runs)
        emit("join_probe_16Mx1M_merge", m / dtm / 1e6, "Mrows/s", dtm,
             psort.sort_traffic_bytes(m + nd, 3)
             + psort.sort_traffic_bytes(m, 3))

    if 12 in configs:
        # 12. config-5 anchor at single-card scale: 256M-row probe x 16M
        # build, a slice of BASELINE configs[4] ("1B fact x 100M dim")
        m = (1 << 28) // sc
        nd = (1 << 24) // sc
        dim = np.arange(nd, dtype=np.uint32)
        np.random.RandomState(15).shuffle(dim)
        dimv = (dim * 7 + 1).astype(np.uint32)
        probe = jnp.asarray(np.random.RandomState(16).randint(
            0, nd, size=m).astype(np.uint32))
        sdb = sort_mod.sort_new("xla")
        sdk12, sdv12 = sdb.sort_with_device_data(jnp.asarray(dim),
                                                 jnp.asarray(dimv))
        jf12 = lambda p: ex.hash_join(sdk12, sdv12, p,  # noqa: E731
                                      build_sorted=True)
        out = jf12(probe)
        # spot-check correctness (full checks are the tests' job)
        f0 = np.asarray(out[0][:1 << 16])
        assert bool(f0.all())
        dt = _timed(jf12, (probe,), runs)
        emit("join_probe_256Mx16M", m / dt / 1e6, "Mrows/s", dt,
             search_traffic_bytes(m, 1, 1))

    if 6 in configs:
        # 6. full join expansion: 16M probes x 4 matches each against a
        # 4M-row build (not a BASELINE config; covers hash_join_expand)
        m = (1 << 24) // sc
        nd = (1 << 22) // sc
        nkeys = max(nd // 4, 1)
        dk = (np.arange(nd, dtype=np.uint32) % nkeys)
        np.random.RandomState(8).shuffle(dk)
        dv = np.arange(nd, dtype=np.int32)
        pk = jnp.asarray(np.random.RandomState(9).randint(
            0, nkeys, size=m).astype(np.uint32))
        cap = 4 * m
        sx = sort_mod.sort_new("xla", elem_dtype="uint")
        sdk6, sdv6 = sx.sort_with_device_data(jnp.asarray(dk),
                                              jnp.asarray(dv))
        efn = lambda p: ex.hash_join_expand(  # noqa: E731
            sdk6, sdv6, p, capacity=cap, build_sorted=True)
        dt = _timed(efn, (pk,), runs)
        total, _, _ = efn(pk)
        assert int(total) == cap
        # probe sort, two bound searches, then per output row a
        # segment search and the gathers of its values
        emit("join_expand_16Mx4", cap / dt / 1e6, "Mpairs/s", dt,
             psort.sort_traffic_bytes(m, 2)
             + 2 * search_traffic_bytes(m, 1, 1)
             + search_traffic_bytes(cap, 1, 3) + 3 * 4 * cap)

    if 7 in configs:
        # 7. rollup: 16M-fact x 1M-dim join -> GROUP BY join key, the
        # restore-free fusion (sorted_output + probe_cols + keys_sorted
        # aggregate): ONE probe sort for the whole pipeline
        from cl_ops_tpu.models.pipeline import rollup_query
        n = (1 << 24) // sc
        nd = max((1 << 20) // sc, 64)

        def rq():
            return rollup_query(n, dim_rows=nd)

        # sanity: group count and measure total must match the merge
        # probe's (full-output equality is the test suite's job)
        gk, table, cnt = rq()
        gk0, table0, cnt0 = rollup_query(n, dim_rows=nd, probe_impl="merge")
        assert int(cnt) == int(cnt0), (int(cnt), int(cnt0))
        assert int(table.sum()) == int(table0.sum())
        dt = _timed(rq, (), runs)
        # probe sort (key + pos + 2 payload cols) + the search + the
        # aggregate's boundary-reduce passes
        bytes_moved = (psort.sort_traffic_bytes(n, 4)
                       + search_traffic_bytes(n, 1, 1) + 8 * 4 * n)
        emit("rollup_16Mx1M", n / dt / 1e6, "Mrows/s", dt, bytes_moved)

    if 8 in configs:
        # 8. TPC-H-Q1 shape: filter -> six-aggregate multi-measure GROUP
        # BY (group_aggregate_cols) over 16M rows / 64K groups in one jit
        # (not a BASELINE config; covers the multi-measure operator)
        from cl_ops_tpu.models.pipeline import q1_query
        n = (1 << 24) // sc
        g = max((1 << 16) // sc, 16)

        def q1():
            return q1_query(n, num_groups=g)

        # sanity (full checks live in the tests and chip_smoke.py)
        cnt, gk, tables, gcnt = q1()
        assert int(tables[4][:int(gcnt)].sum()) == int(cnt)
        dt = _timed(q1, (), runs)
        # ONE fused (validity|key, qty, price) sort + boundary passes:
        # prev-compare, is_new/end_rank/count prefix sums, 2 sum prefix
        # sums, the segmented min/max scans, ends gathers
        bytes_moved = psort.sort_traffic_bytes(n, 3) + 12 * 4 * n
        emit("q1_16Mx64K", n / dt / 1e6, "Mrows/s", dt, bytes_moved)

    if 9 in configs:
        # 9. window functions: sum + row_number over 16M rows / 64K
        # partitions — restore form and the sorted_output fusion
        n = (1 << 24) // sc
        g = max((1 << 16) // sc, 16)
        wk = jnp.asarray(np.random.RandomState(9).randint(
            0, g, size=n).astype(np.uint32))
        wo = jnp.asarray(np.random.RandomState(10).randint(
            0, 1 << 30, size=n).astype(np.uint32))
        wv = jnp.asarray(np.random.RandomState(11).randint(
            0, 100, size=n).astype(np.int32))

        def wfn(k, o, v):
            return ex.window_cols(k, o, (v, None), ("sum", "row_number"))

        def wfn_s(k, o, v):
            out, src = ex.window_cols(k, o, (v, None),
                                      ("sum", "row_number"),
                                      sorted_output=True)
            return (*out, src)

        # sanity (full checks in tests/): the row numbers of a partition
        # are 1..size, so their total is fixed by the partition sizes
        ws, wr = wfn(wk, wo, wv)
        sizes = np.bincount(np.asarray(wk), minlength=g).astype(np.int64)
        assert int(wr.astype(jnp.int64).sum()) == int(
            (sizes * (sizes + 1) // 2).sum())
        seg = 2 * 3 * 4 * n + 4 * n  # two segmented scans + flags
        dt = _timed(wfn, (wk, wo, wv), runs)
        emit("window_16Mx64K", n / dt / 1e6, "Mrows/s", dt,
             psort.sort_traffic_bytes(n, 4) + seg
             + psort.sort_traffic_bytes(n, 3))
        dt = _timed(wfn_s, (wk, wo, wv), runs)
        emit("window_16Mx64K_sorted", n / dt / 1e6, "Mrows/s", dt,
             psort.sort_traffic_bytes(n, 4) + seg)

    if 10 in configs:
        # 10. top-1K of 64M u32 with a payload column (threshold select)
        n = (1 << 26) // sc
        kk = min(1024, n // 16)
        tv = jnp.asarray(np.random.RandomState(12).randint(
            0, 1 << 30, size=n).astype(np.uint32))
        tp = jnp.asarray(np.random.RandomState(13).randint(
            0, 1 << 30, size=n).astype(np.int32))

        def tfn(v, p):
            return ex.top_k(v, kk, p)
        out_v, out_p = tfn(tv, tp)
        hv = np.asarray(tv)
        idx = np.argsort(hv, kind="stable")[:kk]
        assert np.array_equal(np.asarray(out_v), hv[idx])
        assert np.array_equal(np.asarray(out_p), np.asarray(tp)[idx])
        dt = _timed(tfn, (tv, tp), runs)
        # block-extraction form: mask build + KB=4 argmax/clear sweeps +
        # the candidate small-sort (negligible); no n-row sort
        emit("topk_1K_of_64M", n / dt / 1e6, "Mrows/s", dt,
             4 * n + n + 4 * 2 * n)

    if 11 in configs:
        # 11. DISTINCT over 64M rows / 1M distinct values (key-only sort)
        n = (1 << 26) // sc
        du = max((1 << 20) // sc, 16)
        dk = jnp.asarray(np.random.RandomState(14).randint(
            0, du, size=n).astype(np.uint32))

        def dfn(k):
            return ex.distinct(k, capacity=du)
        uv, ucnt = dfn(dk)
        ref_cnt = len(np.unique(np.asarray(dk)))
        assert int(ucnt) == ref_cnt
        dt = _timed(dfn, (dk,), runs)
        emit("distinct_64M_1M", n / dt / 1e6, "Mrows/s", dt,
             psort.sort_traffic_bytes(n, 1) + 4 * 4 * n)

    return 0


if __name__ == "__main__":
    sys.exit(main())
