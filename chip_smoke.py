"""Smoke run of the query engine on one GPU (or four, with --chips 4).

Drives the main path once through the public entry points at real sizes —
the Triton scan and the lax bitonic network, the sorts, filter, group-by
aggregate, join and the pipeline queries — and checks every result against
an independent numpy reference built on the host from the same seeded data.
Each phase prints its first-call time (compile included), its steady time
over 3 calls, and the device's peak memory so far. Any mismatch raises, so
the script exits non-zero.

    python chip_smoke.py              # one GPU, every phase
    python chip_smoke.py --chips 4    # four GPUs, the distributed phase only
    python chip_smoke.py --rehearse   # CPU, tiny sizes (never claims a GPU)

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


# Full sizes, and the CPU rehearsal's tiny ones. The four-card phase runs
# BASELINE configs[4] at its own size: 1B Zipf fact rows x 100M dim rows.
FULL = dict(scan_wide=1 << 28, scan_narrow=1 << 24, bitonic=1 << 24,
            sort_small=1 << 20, radix_kv=1 << 24, filter=1 << 26,
            agg_rows=1 << 28, agg_groups=1 << 20, probe=1 << 28,
            build=1 << 24, analytics=1 << 26, q1=1 << 24, q1_groups=1 << 16,
            rollup=1 << 24, rollup_dim=1 << 20, star=1 << 24,
            dist_fact=1_000_000_000, dist_dim=100_000_000)
TINY = dict(scan_wide=50_000, scan_narrow=20_000, bitonic=1 << 12,
            sort_small=5_000, radix_kv=20_000, filter=40_000,
            agg_rows=1 << 17, agg_groups=1 << 9, probe=60_000,
            build=8_000, analytics=1 << 15, q1=1 << 15, q1_groups=256,
            rollup=1 << 14, rollup_dim=1 << 10, star=1 << 14,
            dist_fact=1 << 16, dist_dim=1 << 12)


class Smoke:
    def __init__(self, jax, sizes, seed: int):
        self.jax = jax
        self.sizes = sizes
        self.seed = seed

    def rng(self, salt: int):
        return np.random.default_rng([self.seed, salt])

    def phase(self, name: str, fn, check):
        """Run fn once (compile + run), then 3 more times; check the last
        result; print the timings and the device's peak memory."""
        jax = self.jax
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        steady = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            steady.append(time.perf_counter() - t0)
        check(out)
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 for d in jax.devices()]
        peak = max(peaks) if None not in peaks else "n/a"
        print(f"  {name}: first_call_s={first:.4f} (compile included) "
              f"steady_s={min(steady):.6f} (min of 3, mean "
              f"{sum(steady) / 3:.6f}) peak_bytes_in_use={peak} "
              f"(largest over devices)", flush=True)
        return out


def _eq(got, want, what: str):
    got = np.asarray(got)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.flatnonzero(got != want) if got.shape == want.shape else []
        raise AssertionError(
            f"{what}: mismatch (shape {got.shape} vs {want.shape}, "
            f"{len(bad)} differing, first at {bad[:5]})")


def phase_kernels(s: Smoke):
    import jax.numpy as jnp
    from cl_ops_tpu.ops.scan import scan_new
    from cl_ops_tpu.ops.sort import sort_new
    print("phase kernels", flush=True)
    for n, sum_dt in ((s.sizes["scan_wide"], np.uint64),
                      (s.sizes["scan_narrow"], np.uint32)):
        x = s.rng(1).integers(0, 2 ** 32, n, dtype=np.uint32)
        want = np.cumsum(x, dtype=sum_dt) - x.astype(sum_dt)  # exclusive
        dx = jnp.asarray(x)
        for impl in ("blelloch", "xla"):
            sc = scan_new(impl, elem_dtype="uint", sum_dtype=sum_dt)
            s.phase(f"scan {impl} u32->{np.dtype(sum_dt).name} n={n}",
                    lambda: sc.scan_with_device_data(dx),
                    lambda out: _eq(out, want, f"scan {impl}"))
        del dx
    n = s.sizes["bitonic"]
    x = s.rng(2).integers(0, 2 ** 32, n, dtype=np.uint32)
    want = np.sort(x)
    dx = jnp.asarray(x)
    for impl in ("abitonic", "xla"):
        so = sort_new(impl, elem_dtype="uint")
        s.phase(f"sort {impl} u32 n={n}",
                lambda: so.sort_with_device_data(dx),
                lambda out: _eq(out, want, f"sort {impl}"))


def phase_sort(s: Smoke):
    import jax.numpy as jnp
    from cl_ops_tpu.ops.sort import sort_new
    print("phase sort", flush=True)
    n = s.sizes["sort_small"]
    x = s.rng(3).integers(0, 2 ** 32, n, dtype=np.uint32)
    want = np.sort(x)
    dx = jnp.asarray(x)
    so = sort_new("abitonic", elem_dtype="uint")
    s.phase(f"abitonic u32 n={n}", lambda: so.sort_with_device_data(dx),
            lambda out: _eq(out, want, "abitonic"))
    n = s.sizes["radix_kv"]
    k = s.rng(4).integers(0, 2 ** 64, n, dtype=np.uint64)
    v = s.rng(5).integers(0, 2 ** 64, n, dtype=np.uint64)
    order = np.argsort(k, kind="stable")  # satradix is stable
    want_k, want_v = k[order], v[order]
    dk, dv = jnp.asarray(k), jnp.asarray(v)
    for impl in ("satradix", "xla"):
        so = sort_new(impl, elem_dtype="ulong")

        def check(out, impl=impl):
            _eq(out[0], want_k, f"{impl} keys")
            _eq(out[1], want_v, f"{impl} values")
        s.phase(f"{impl} u64 key-value n={n}",
                lambda: so.sort_with_device_data(dk, dv), check)


def phase_filter(s: Smoke):
    import jax.numpy as jnp
    from cl_ops_tpu.ops.exec import filter_compact
    print("phase filter", flush=True)
    n = s.sizes["filter"]
    x = s.rng(6).integers(0, 2 ** 32, n, dtype=np.uint32)
    pay = s.rng(7).integers(0, 2 ** 31, n, dtype=np.int32)
    thr = np.uint32(2 ** 32 // 10)  # 10% selectivity
    keep = x < thr
    want_x, want_p = x[keep], pay[keep]
    dx, dp = jnp.asarray(x), jnp.asarray(pay)

    def pred(v):  # one function object: the predicate is a static arg
        return v < thr

    def check(out):
        cnt = int(out[0])
        if cnt != want_x.size:
            raise AssertionError(f"filter count {cnt} != {want_x.size}")
        _eq(np.asarray(out[1])[:cnt], want_x, "filter data")
        _eq(np.asarray(out[2])[:cnt], want_p, "filter payload")
    s.phase(f"filter_compact n={n} sel=0.1",
            lambda: filter_compact(dx, pred, dp), check)


def phase_aggregate(s: Smoke):
    import jax.numpy as jnp
    from cl_ops_tpu.ops.exec import group_aggregate_sorted
    print("phase aggregate", flush=True)
    n, g = s.sizes["agg_rows"], s.sizes["agg_groups"]
    keys = s.rng(8).integers(0, g, n, dtype=np.int32)
    vals = s.rng(9).integers(0, 1024, n, dtype=np.uint32)
    cnt = np.bincount(keys, minlength=g)
    sums = np.bincount(keys, weights=vals, minlength=g).astype(np.uint64)
    present = np.flatnonzero(cnt)
    dk, dv = jnp.asarray(keys), jnp.asarray(vals)

    def check(out):
        gk, table, c = out
        c = int(c)
        if c != present.size:
            raise AssertionError(f"group count {c} != {present.size}")
        _eq(np.asarray(gk)[:c], present.astype(np.int32), "group keys")
        _eq(np.asarray(table)[:c].astype(np.uint64), sums[present],
            "group sums")
    s.phase(f"group_aggregate_sorted sum n={n} groups={g}",
            lambda: group_aggregate_sorted(dk, dv, num_groups=g, agg="sum"),
            check)


def _join_data(s: Smoke, m: int, nb: int):
    """Unique even build keys (shuffled) with value key*K mod 2^32, and
    uniform probes over [0, 2nb): even probes hit, odd ones miss."""
    build = (s.rng(10).permutation(nb).astype(np.uint32) * np.uint32(2))
    mult = np.uint32(2654435761)
    bvals = build * mult
    probe = s.rng(11).integers(0, 2 * nb, m, dtype=np.uint32)
    return build, bvals, probe, probe % 2 == 0, probe * mult


def phase_join(s: Smoke):
    import jax.numpy as jnp
    from cl_ops_tpu.ops.exec import hash_join
    print("phase join", flush=True)
    m, nb = s.sizes["probe"], s.sizes["build"]
    build, bvals, probe, want_found, want_vals = _join_data(s, m, nb)
    db, dbv, dp = jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe)

    def check(out):
        found, vals = (np.asarray(o) for o in out)
        _eq(found, want_found, "join found")
        _eq(vals[found], want_vals[want_found], "join values")
    s.phase(f"hash_join probe={m} build={nb}",
            lambda: hash_join(db, dbv, dp), check)


def phase_queries(s: Smoke):
    import jax
    import jax.numpy as jnp
    from cl_ops_tpu.models import pipeline as pl
    from cl_ops_tpu.ops.rng import threefry
    print("phase queries", flush=True)

    def bits(seed, n, channel):
        ids = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
        return np.asarray(threefry.random_bits(seed, ids,
                                               jnp.uint32(channel)))

    # analytics: SELECT key % G, SUM(v) WHERE v < 512 GROUP BY 1
    n, g = s.sizes["analytics"], 1024
    keys = bits(s.seed, n, 0) % np.uint32(1 << 20)
    vals = bits(s.seed, n, 1) % np.uint32(1 << 10)
    keep = vals < 512
    want_tbl = np.bincount(keys[keep] % g, weights=vals[keep], minlength=g)

    def check_analytics(out):
        if int(out[0]) != int(keep.sum()):
            raise AssertionError("analytics count")
        _eq(np.asarray(out[1]).astype(np.float64), want_tbl,
            "analytics table")
    s.phase(f"analytics_query n={n}",
            lambda: pl.analytics_query(n, num_groups=g, seed=s.seed),
            check_analytics)

    # q1: six aggregates over WHERE qty < 768 GROUP BY key
    n, g = s.sizes["q1"], s.sizes["q1_groups"]
    k = (bits(s.seed, n, 0) % np.uint32(g)).astype(np.int64)
    qty = (bits(s.seed, n, 1) % np.uint32(1024)).astype(np.int64)
    price = (bits(s.seed, n, 2) % np.uint32(10000)).astype(np.int64)
    mk = qty < 768
    k, qty, price = k[mk], qty[mk], price[mk]
    uk = np.unique(k)
    cnt = np.bincount(k, minlength=g)[uk]
    sq = np.bincount(k, weights=qty, minlength=g)[uk]
    sp = np.bincount(k, weights=price, minlength=g)[uk]
    mnq = np.full(g, np.iinfo(np.int64).max)
    np.minimum.at(mnq, k, qty)
    mxp = np.full(g, -1)
    np.maximum.at(mxp, k, price)

    def check_q1(out):
        count, gk, (tsq, tsp, tmn, tmx, tc, tmean), gcnt = out
        c = int(gcnt)
        if int(count) != int(mk.sum()) or c != uk.size:
            raise AssertionError("q1 counts")
        _eq(np.asarray(gk)[:c].astype(np.int64), uk, "q1 keys")
        _eq(np.asarray(tsq)[:c].astype(np.float64), sq, "q1 sum qty")
        _eq(np.asarray(tsp)[:c].astype(np.float64), sp, "q1 sum price")
        _eq(np.asarray(tmn)[:c].astype(np.int64), mnq[uk], "q1 min qty")
        _eq(np.asarray(tmx)[:c].astype(np.int64), mxp[uk], "q1 max price")
        _eq(np.asarray(tc)[:c].astype(np.int64), cnt, "q1 count")
        # the mean divides exact integer sums, so only the divide rounds
        np.testing.assert_allclose(np.asarray(tmean)[:c], sp / cnt,
                                   rtol=1e-6, err_msg="q1 mean price")
    s.phase(f"q1_query n={n} groups={g}",
            lambda: pl.q1_query(n, num_groups=g, seed=s.seed), check_q1)

    # rollup: SUM(measure) of rows whose key is in dim, GROUP BY fact key
    n, nd = s.sizes["rollup"], s.sizes["rollup_dim"]
    keys = bits(s.seed, n, 0) % np.uint32(2 * nd)
    meas = (bits(s.seed, n, 1) % np.uint32(1 << 10)).astype(np.int64)
    uk, inv = np.unique(keys, return_inverse=True)
    want = np.bincount(inv, weights=meas * (keys % 2 == 0))

    def check_rollup(out):
        gk, sums, c = out
        c = int(c)
        if c != uk.size:
            raise AssertionError(f"rollup groups {c} != {uk.size}")
        _eq(np.asarray(gk)[:c], uk, "rollup keys")
        _eq(np.asarray(sums)[:c].astype(np.float64), want, "rollup sums")
    s.phase(f"rollup_query n={n} dim={nd}",
            lambda: pl.rollup_query(n, dim_rows=nd, seed=s.seed),
            check_rollup)

    # star: filter -> join a 16K-row dim -> GROUP BY its category
    n, nd, cats = s.sizes["star"], 1 << 14, 256
    keys = bits(s.seed, n, 0) % np.uint32(nd)
    vals = bits(s.seed, n, 1) % np.uint32(1 << 10)
    dim_cat = bits(s.seed + 1, nd, 2) % np.uint32(cats)
    keep = vals < 512
    want_tbl = np.bincount(dim_cat[keys[keep]], weights=vals[keep],
                           minlength=cats)

    def check_star(out):
        if int(out[0]) != int(keep.sum()):
            raise AssertionError("star count")
        _eq(np.asarray(out[1]).astype(np.float64), want_tbl, "star table")
    s.phase(f"star_query n={n} dim={nd}",
            lambda: pl.star_query(n, dim_rows=nd, num_cats=cats,
                                  seed=s.seed), check_star)


def _zipf_fact(dim, m: int, seed: int, a: float = 1.2):
    """m fact keys: dim[k] for ranks k from the truncated Zipf(a) law
    P(k) ~ (k+1)^-a over the dim table (inverse CDF), + 1 with chance 1/4."""
    import jax
    import jax.numpy as jnp
    nb = dim.shape[0]
    cdf = jnp.cumsum(jnp.arange(1, nb + 1, dtype=jnp.float64) ** -a)
    ku, km = jax.random.split(jax.random.key(seed))
    u = jax.random.uniform(ku, (m,), jnp.float64) * cdf[-1]
    ranks = jnp.minimum(jnp.searchsorted(cdf, u, side="right"), nb - 1)
    miss = jax.random.bernoulli(km, 0.25, (m,)).astype(jnp.uint32)
    return jnp.take(dim, ranks) + miss


def phase_distributed(s: Smoke, n_dev: int):
    """dist_hash_join over Zipf(1.2) fact keys (the shuffle overflows and
    re-plans), dist_group_aggregate and dist_sort on a 1-D mesh."""
    import jax
    import jax.numpy as jnp
    from cl_ops_tpu import parallel
    from cl_ops_tpu.ops.exec import hash_join
    from cl_ops_tpu.parallel.mesh import put_sharded
    print(f"phase distributed ({n_dev} devices)", flush=True)
    mesh = parallel.make_mesh(n_dev)

    def spans(arrs, what):
        for a in arrs:
            if len(a.sharding.device_set) != n_dev:
                raise AssertionError(f"{what}: output on "
                                     f"{len(a.sharding.device_set)} devices")

    m, nb = s.sizes["dist_fact"], s.sizes["dist_dim"]
    rng = s.rng(12)
    dim = (rng.permutation(nb).astype(np.uint32) * np.uint32(2))
    # fact rows: the dim key of a Zipf(1.2) rank (the permutation shuffles
    # ranks over keys), plus one for a quarter of them (25% miss). Drawn
    # on the device in bulk; the reference reads the host copy.
    fact = np.asarray(_zipf_fact(jnp.asarray(dim), m, s.seed))
    mult = np.uint32(2654435761)
    dvals = dim * mult
    want_found = fact % 2 == 0
    want_vals = fact * mult
    # buckets sized for an even spread: the Zipf head overflows the hash
    # plan, and the join re-plans with range splitters
    cap_b = 2 * nb // (n_dev * n_dev)
    cap_p = m // (n_dev * n_dev)
    dd, ddv, df = (put_sharded(jnp.asarray(a), mesh)
                   for a in (dim, dvals, fact))

    def check_join(out):
        spans(out, "dist_hash_join")
        found, vals = (np.asarray(o) for o in out)
        _eq(found, want_found, "dist join found")
        _eq(vals[found], want_vals[want_found], "dist join values")
    out = s.phase(
        f"dist_hash_join fact={m} (zipf 1.2) dim={nb}",
        lambda: parallel.dist_hash_join(dd, ddv, df, mesh,
                                        capacity_build=cap_b,
                                        capacity_probe=cap_p),
        check_join)
    # the same join on one card
    one = hash_join(jnp.asarray(dim), jnp.asarray(dvals), jnp.asarray(fact))
    _eq(np.asarray(one[0]), np.asarray(out[0]), "one-card join found")
    del out, one

    gk_np = (fact % np.uint32(1 << 20)).astype(np.int32)
    v_np = (fact & np.uint32(1023)).astype(np.uint32)
    cnt = np.bincount(gk_np, minlength=1 << 20)
    sums = np.bincount(gk_np, weights=v_np, minlength=1 << 20)
    dk, dv = (put_sharded(jnp.asarray(a), mesh)
              for a in (gk_np, v_np))

    def check_agg(out):
        gk, table, c = out
        spans((gk, table, c), "dist_group_aggregate")
        gk, table, c = (np.asarray(o) for o in (gk, table, c))
        per = gk.size // n_dev
        got_k, got_s = [], []
        for i in range(n_dev):
            got_k.append(gk[i * per:i * per + c[i]])
            got_s.append(table[i * per:i * per + c[i]])
        got_k, got_s = np.concatenate(got_k), np.concatenate(got_s)
        order = np.argsort(got_k)
        present = np.flatnonzero(cnt)
        _eq(got_k[order], present.astype(np.int32), "dist agg keys")
        # u32 sums wrap: the Zipf head key's sum passes 2^32
        _eq(got_s[order], (sums[present].astype(np.uint64)
                           % (1 << 32)).astype(np.uint32), "dist agg sums")
    s.phase(f"dist_group_aggregate rows={m} (zipf keys)",
            lambda: parallel.dist_group_aggregate(
                dk, dv, mesh, num_groups=(1 << 20), capacity=cap_p,
                agg="sum"),
            check_agg)
    del dk, dv

    x = s.rng(13).integers(0, 2 ** 32, m, dtype=np.uint32)
    want = np.sort(x)
    dx = put_sharded(jnp.asarray(x), mesh)

    def check_sort(out):
        spans((out,), "dist_sort")
        _eq(out, want, "dist_sort")
    s.phase(f"dist_sort u32 n={m}", lambda: parallel.dist_sort(dx, mesh),
            check_sort)
    one = jax.block_until_ready(jnp.sort(jnp.asarray(x)))
    _eq(np.asarray(one), want, "one-card sort")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the distributed phase on 4 devices")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at tiny sizes (no GPU claimed)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import os
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count"
                                   f"={args.chips}").strip()
    import jax
    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU found (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    if len(jax.devices()) < args.chips:
        print(f"chip_smoke: {args.chips} devices asked, "
              f"{len(jax.devices())} found", file=sys.stderr)
        return 2
    from cl_ops_tpu.utils.platform import enable_compile_cache
    enable_compile_cache()
    print(f"card: {_nvidia_smi()}", flush=True)
    print(f"jax {jax.__version__} platform={dev.platform} "
          f"kind={dev.device_kind} devices={len(jax.devices())}",
          flush=True)
    s = Smoke(jax, TINY if args.rehearse else FULL, args.seed)
    t0 = time.perf_counter()
    if args.chips == 4:
        phase_distributed(s, 4)
    else:
        for ph in (phase_kernels, phase_sort, phase_filter, phase_aggregate,
                   phase_join, phase_queries):
            ph(s)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
