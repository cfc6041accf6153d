"""Kernel decisions: each hand kernel against XLA's plain form, on the card.

Times, at the shapes the operators use, every choice between a hand kernel
and XLA's plain form (PERF.md keeps the table): the Triton Blelloch scan
against `jnp.cumsum`, alone and inside the 256M-row aggregate; the join's
binary-search probe against its sort-merge probe; and XLA's own time, with
its share of the published bandwidth peak, for the kernels that became
plain `lax` (the operator sorts, the segmented scans, the dense aggregate,
satradix and the bitonic network). With --trace it also names the device
kernels XLA runs for the 1- to 4-column operator sorts.

    python -m cl_ops_tpu.bench.kernel_choice [--trace DIR] [--out FILE]

Each line is one JSON row naming the device. Times are the mean of --runs
calls after a warm-up call, each ending in block_until_ready.
"""

from __future__ import annotations

import argparse
import json
import sys


def _rows(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cl_ops_tpu.bench import common
    from cl_ops_tpu.bench.roofline import roofline_row
    from cl_ops_tpu.ops.exec import psort

    runs = args.runs
    sc = args.scale
    on_gpu = jax.devices()[0].platform == "gpu"

    def row(decision, variant, shape, fn, fargs, bytes_moved=None):
        secs = common.time_async(fn, fargs, runs) / runs
        r = {"decision": decision, "variant": variant, "shape": shape,
             "seconds": secs}
        if on_gpu and bytes_moved is not None:
            r.update(roofline_row(bytes_moved, secs))
        return r

    rng = np.random.default_rng(0)
    if on_gpu:  # also brings the card's clocks up before the first row
        from cl_ops_tpu.bench.roofline import measured_copy_gbs
        yield {"decision": "copy", "variant": "a+1 over 1 GiB",
               "shape": "i32", "gb_s": measured_copy_gbs()}

    # --- row 5: the Blelloch scan, alone ---------------------------------
    from cl_ops_tpu.ops.scan import kernels
    for n, sdt in (((1 << 24) // sc, jnp.uint32),
                   ((1 << 24) // sc, jnp.uint64),
                   ((1 << 28) // sc, jnp.uint32),
                   ((1 << 28) // sc, jnp.uint64)):
        x = jnp.asarray(rng.integers(0, 2 ** 32, n, dtype=np.uint32))
        shape = f"u32->{jnp.dtype(sdt).name} n={n}"
        least = kernels.scan_least_bytes(n, jnp.uint32, sdt)
        tri = jax.jit(lambda a, s=sdt: kernels.scan_1d(a, sum_dtype=s))
        xla = jax.jit(lambda a, s=sdt: jnp.cumsum(a.astype(s)) - a.astype(s))
        yield row("scan", "triton_blelloch", shape, tri, (x,), least)
        yield row("scan", "xla_cumsum", shape, xla, (x,), least)
        del x

    # --- row 5: the scan inside the 256M-row x 1M-group aggregate --------
    from cl_ops_tpu.ops.exec import aggregate, group_aggregate_sorted
    n, g = (1 << 28) // sc, (1 << 20) // sc
    keys = jnp.asarray(rng.integers(0, g, n, dtype=np.int32))
    vals = jnp.asarray(rng.integers(0, 1024, n, dtype=np.uint32))
    xla_csum = aggregate._csum

    def triton_csum(x, dtype=None):
        dt = jnp.dtype(dtype if dtype is not None else x.dtype)
        return kernels.scan_1d(x.astype(dt), sum_dtype=dt, exclusive=False)
    for name, route in (("triton_blelloch", triton_csum),
                        ("xla_cumsum", xla_csum)):
        aggregate._csum = route
        jax.clear_caches()
        yield row("scan_in_aggregate", name, f"rows={n} groups={g}",
                  lambda k, v: group_aggregate_sorted(k, v, num_groups=g),
                  (keys, vals))
    aggregate._csum = xla_csum
    jax.clear_caches()
    del keys, vals

    # --- row 8: the join probe, direct search against sort-merge ---------
    from cl_ops_tpu.ops.exec import hash_join
    from cl_ops_tpu.ops.exec.probe import search_traffic_bytes
    for m, nb in (((1 << 24) // sc, (1 << 20) // sc),
                  ((1 << 28) // sc, (1 << 24) // sc)):
        build = jnp.sort(jnp.asarray(rng.permutation(nb).astype(np.uint32)))
        bv = build * jnp.uint32(7)
        probe = jnp.asarray(rng.integers(0, nb, m, dtype=np.uint32))
        for impl in ("direct", "merge"):
            fn = jax.jit(lambda b, v, p, i=impl: hash_join(
                b, v, p, build_sorted=True, probe_impl=i))
            least = (search_traffic_bytes(m, 1, 1) if impl == "direct" else
                     psort.sort_traffic_bytes(m + nb, 3)
                     + psort.sort_traffic_bytes(m, 3))
            yield row("join_probe", impl, f"probe={m} build={nb}", fn,
                      (build, bv, probe), least)
        del build, bv, probe

    # --- row 1: the operator sorts, 1 to 4 i32 columns -------------------
    n = (1 << 24) // sc
    cols = [jnp.asarray(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32))
            for _ in range(4)]
    sorts = {"1col": (1, None), "2col_kv": (2, 1), "3col_nk1": (3, 1),
             "4col_nk3": (4, 3)}
    for name, (c, nk) in sorts.items():
        fn = jax.jit(lambda *a, nk=nk: psort.sort_i32_cols(a, num_keys=nk))
        yield row("operator_sort", name, f"n={n}", fn, tuple(cols[:c]),
                  psort.sort_traffic_bytes(n, c))

    # --- rows 2-3: the reference's algorithms, by name -------------------
    from cl_ops_tpu.ops.sort import sort_new
    x = cols[0].astype(jnp.uint32)
    for impl in ("abitonic", "xla"):
        so = sort_new(impl, elem_dtype="uint")
        yield row("sort_by_name", impl, f"u32 n={n}",
                  so.sort_with_device_data, (x,),
                  psort.sort_traffic_bytes(n, 1))
    k64 = jnp.asarray(rng.integers(0, 2 ** 64, n, dtype=np.uint64))
    v64 = jnp.asarray(rng.integers(0, 2 ** 64, n, dtype=np.uint64))
    for impl in ("satradix", "xla"):
        so = sort_new(impl, elem_dtype="ulong")
        yield row("sort_by_name", impl, f"u64 kv n={n}",
                  so.sort_with_device_data, (k64, v64),
                  psort.sort_traffic_bytes(n, 5))
    del k64, v64

    # --- row 7: segmented scans at the window / q1 shapes ----------------
    from cl_ops_tpu.ops.scan import segmented_scan_1d
    for groups in ((1 << 16) // sc,):
        seg_ids = jnp.sort(jnp.asarray(rng.integers(0, groups, n,
                                                    dtype=np.int32)))
        flags = jnp.concatenate([jnp.ones((1,), jnp.int32),
                                 (seg_ids[1:] != seg_ids[:-1])
                                 .astype(jnp.int32)])
        v = cols[1]
        for op in ("add", "max"):
            fn = jax.jit(lambda a, f, o=op: segmented_scan_1d(
                a, f, op=o, exclusive=False))
            yield row("segmented_scan", op, f"n={n} segments={groups}",
                      fn, (v, flags), 3 * 4 * n)

    # --- row 9: the dense aggregate (segment ops) ------------------------
    from cl_ops_tpu.ops.exec import group_aggregate_dense_cols
    q = jnp.asarray(rng.integers(0, 1024, n, dtype=np.int32))
    for groups in (4, 1024):
        gid = jnp.asarray(rng.integers(0, groups, n, dtype=np.int32))
        fn = jax.jit(lambda gi, a, gr=groups: group_aggregate_dense_cols(
            gi, (a, a, a), ("sum", "min", "count"), num_groups=gr))
        yield row("dense_aggregate", "segment_ops", f"n={n} groups={groups}",
                  fn, (gid, q), 2 * 4 * n)


def _trace_sorts(trace_dir: str, sc: int):
    """Device kernel names XLA runs for each operator sort shape."""
    import glob
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    from cl_ops_tpu.ops.exec import psort
    n = (1 << 24) // sc
    rng = np.random.default_rng(1)
    cols = [jnp.asarray(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32))
            for _ in range(4)]
    for name, (c, nk) in {"1col": (1, None), "2col_kv": (2, 1),
                          "3col_nk1": (3, 1), "4col_nk3": (4, 3)}.items():
        fn = jax.jit(lambda *a, nk=nk: psort.sort_i32_cols(a, num_keys=nk))
        jax.block_until_ready(fn(*cols[:c]))
        d = os.path.join(trace_dir, name)
        with jax.profiler.trace(d):
            jax.block_until_ready(fn(*cols[:c]))
        names = {}
        for path in glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                              recursive=True):
            prof = jax.profiler.ProfileData.from_file(path)
            for plane in prof.planes:
                if not plane.name.startswith("/device:GPU"):
                    continue
                for line in plane.lines:
                    for ev in line.events:
                        names[ev.name] = names.get(ev.name, 0.0) + \
                            ev.duration_ns
        yield {"decision": "operator_sort_kernels", "variant": name,
               "shape": f"n={n}",
               "kernels_ns": dict(sorted(names.items(),
                                         key=lambda kv: -kv[1])[:12])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every size by this (CPU smoke runs)")
    ap.add_argument("--trace", default=None,
                    help="directory for profiler traces of the sorts")
    ap.add_argument("--out", default=None, help="also append rows here")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_enable_x64", True)
    from cl_ops_tpu.bench import common
    from cl_ops_tpu.utils.platform import enable_compile_cache
    if args.scale == 1:
        common.require_gpu("kernel_choice")
        enable_compile_cache()
    device = common.device_fields()
    sink = open(args.out, "a") if args.out else None
    rows = _rows(args)
    if args.trace:
        import itertools
        rows = itertools.chain(rows, _trace_sorts(args.trace, args.scale))
    for r in rows:
        r.update(device)
        line = json.dumps(r)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
