"""Distributed-layer tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from cl_ops_tpu import parallel


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return parallel.make_mesh(8)


def test_dist_scan_exclusive(mesh8):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 1000, size=8 * 1000).astype(np.uint32)
    out = parallel.dist_scan(x, mesh8, sum_dtype=np.uint64)
    expect = np.cumsum(x.astype(np.uint64)) - x
    np.testing.assert_array_equal(np.asarray(out), expect)


def test_dist_scan_inclusive(mesh8):
    rng = np.random.RandomState(1)
    x = rng.randint(0, 1000, size=8 * 64).astype(np.int32)
    out = parallel.dist_scan(x, mesh8, sum_dtype=np.int64, exclusive=False)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.cumsum(x.astype(np.int64)))


def test_dist_scan_sharding_preserved(mesh8):
    x = np.arange(8 * 128, dtype=np.uint32)
    out = parallel.dist_scan(x, mesh8, sum_dtype=np.uint32)
    assert len(out.sharding.device_set) == 8


@pytest.mark.parametrize("exclusive", [True, False])
def test_dist_scan_wraps_in_sum_dtype(mesh8, exclusive):
    """u32 sums wrap modulo 2^32 across chips and stay u32 (the carry of
    earlier chips must not widen to u64 under x64)."""
    rng = np.random.RandomState(3)
    x = rng.randint(0, 1 << 32, size=8 * 300, dtype=np.uint64
                    ).astype(np.uint32)
    out = parallel.dist_scan(x, mesh8, sum_dtype=np.uint32,
                             exclusive=exclusive)
    expect = np.cumsum(x, dtype=np.uint32)
    if exclusive:
        expect = expect - x
    assert out.dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(out), expect)


def test_dist_scan_uneven_rejected(mesh8):
    with pytest.raises(ValueError):
        parallel.dist_scan(np.arange(9, dtype=np.uint32), mesh8,
                           sum_dtype=np.uint64)


def test_dist_scan_pallas_interpret(mesh8):
    """Full-range u32 values into u64 sums, with shards longer than a
    scan block (4096 elements)."""
    rng = np.random.RandomState(2)
    x = rng.randint(0, 1 << 32, size=8 * 9000, dtype=np.uint64
                    ).astype(np.uint32)
    out = parallel.dist_scan(x, mesh8, sum_dtype=np.uint64)
    expect = np.cumsum(x.astype(np.uint64)) - x
    np.testing.assert_array_equal(np.asarray(out), expect)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("op,exclusive", [("add", True), ("add", False),
                                          ("min", False), ("max", True)])
def test_dist_segmented_scan(mesh8, op, exclusive, dtype):
    """Per-segment scans across shards: flags landing on and off shard
    boundaries, segments spanning several shards."""
    from tests.test_segmented import host_segmented_scan
    rng = np.random.RandomState(17)
    n = 8 * 512
    x = rng.randint(-1000 if dtype == np.int32 else 0, 1000,
                    size=n).astype(dtype)
    flags = (rng.rand(n) < 0.004).astype(np.int32)  # ~16 flags, long runs
    flags[512] = 1       # exactly on a shard boundary
    flags[3 * 512:5 * 512] = 0  # a run spanning >2 shards
    out = parallel.dist_segmented_scan(
        x, flags, mesh8, op=op, exclusive=exclusive)
    expect = host_segmented_scan(x, flags, dtype, exclusive, op)
    np.testing.assert_array_equal(np.asarray(out), expect)


def test_dist_segmented_scan_no_flags(mesh8):
    """Degenerates to dist_scan when nothing restarts."""
    x = np.arange(8 * 64, dtype=np.uint32)
    out = parallel.dist_segmented_scan(x, np.zeros(8 * 64, np.int32), mesh8,
                                       exclusive=False)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.cumsum(x).astype(np.uint32))


def test_dist_sort(mesh8):
    rng = np.random.RandomState(10)
    x = rng.randint(0, 1 << 31, size=8 * 4096, dtype=np.int64).astype(np.uint32)
    out = parallel.dist_sort(x, mesh8)
    np.testing.assert_array_equal(np.asarray(out), np.sort(x))
    assert len(out.sharding.device_set) == 8


def test_dist_sort_descending(mesh8):
    rng = np.random.RandomState(11)
    x = rng.randint(-1000, 1000, size=8 * 512).astype(np.int32)
    out = parallel.dist_sort(x, mesh8, ascending=False)
    np.testing.assert_array_equal(np.asarray(out), np.sort(x)[::-1])


def test_dist_sort_key_value(mesh8):
    rng = np.random.RandomState(12)
    x = rng.randint(0, 100, size=8 * 256).astype(np.uint32)
    v = np.arange(8 * 256, dtype=np.int32)
    out, vout = parallel.dist_sort(x, mesh8, values=v)
    np.testing.assert_array_equal(np.asarray(out), np.sort(x))
    np.testing.assert_array_equal(x[np.asarray(vout)], np.asarray(out))


def test_dist_sort_non_po2_shards(mesh8):
    """Shards of a non-power-of-two length pad to the network size."""
    rng = np.random.RandomState(13)
    x = rng.randint(0, 1 << 31, size=8 * 1000, dtype=np.int64).astype(np.uint32)
    out = parallel.dist_sort(x, mesh8)
    np.testing.assert_array_equal(np.asarray(out), np.sort(x))


def test_partition_exchange(mesh8):
    from cl_ops_tpu.parallel.shuffle import partition_exchange
    import jax.numpy as jnp
    rng = np.random.RandomState(20)
    n = 8 * 512
    data = rng.randint(0, 1 << 30, size=n).astype(np.uint32)
    part = (data % 8).astype(np.int32)  # hash partition by low bits
    cap = 256
    counts, dropped, out = partition_exchange(
        jnp.asarray(data), jnp.asarray(part), mesh8, capacity=cap)
    counts = np.asarray(counts).reshape(8, 8)  # [dst, src]
    assert int(np.asarray(dropped).sum()) == 0
    out = np.asarray(out).reshape(8, 8, cap)   # [dst, src, slot]
    for dst in range(8):
        got = np.sort(np.concatenate(
            [out[dst, s, :counts[dst, s]] for s in range(8)]))
        expect = np.sort(data[part == dst])
        np.testing.assert_array_equal(got, expect)


def test_partition_exchange_overflow(mesh8):
    from cl_ops_tpu.parallel.shuffle import partition_exchange
    import jax.numpy as jnp
    n = 8 * 64
    data = np.arange(n, dtype=np.uint32)
    part = np.zeros(n, np.int32)  # everything to chip 0: overflow forced
    counts, dropped, out = partition_exchange(
        jnp.asarray(data), jnp.asarray(part), mesh8, capacity=16)
    assert int(np.asarray(dropped).sum()) == n - 8 * 16


def test_dist_hash_join(mesh8):
    from cl_ops_tpu.parallel.join import dist_hash_join
    import jax.numpy as jnp
    rng = np.random.RandomState(30)
    dim_keys = np.unique(rng.randint(0, 1 << 20, size=600).astype(np.uint32))
    nb = (len(dim_keys) // 8) * 8
    dim_keys = dim_keys[:nb]
    dim_vals = (dim_keys * 3 + 1).astype(np.uint32)
    fact = np.concatenate([
        dim_keys[rng.randint(0, nb, size=8 * 200)],
        rng.randint(1 << 20, 1 << 21, size=8 * 56).astype(np.uint32)])
    rng.shuffle(fact)
    found, vals = dist_hash_join(
        jnp.asarray(dim_keys), jnp.asarray(dim_vals), jnp.asarray(fact),
        mesh8, capacity_build=nb, capacity_probe=len(fact))
    found, vals = np.asarray(found), np.asarray(vals)
    expect = np.isin(fact, dim_keys)
    np.testing.assert_array_equal(found, expect)
    np.testing.assert_array_equal(vals[expect], fact[expect] * 3 + 1)


def test_dist_group_aggregate(mesh8):
    from cl_ops_tpu.parallel.aggregate import dist_group_aggregate
    import jax.numpy as jnp
    rng = np.random.RandomState(31)
    n = 8 * 512
    keys = rng.randint(0, 100, size=n).astype(np.uint32)
    vals = rng.randint(0, 50, size=n).astype(np.int32)
    gk, table, cnt = dist_group_aggregate(
        jnp.asarray(keys), jnp.asarray(vals), mesh8,
        num_groups=256, capacity=n, agg="sum")
    gk = np.asarray(gk).reshape(8, 256)
    table = np.asarray(table).reshape(8, 256)
    cnt = np.asarray(cnt).reshape(8)
    got = {}
    for c in range(8):
        for i in range(cnt[c]):
            got[int(gk[c, i])] = int(table[c, i])
    expect = {int(k): int(vals[keys == k].sum()) for k in np.unique(keys)}
    assert got == expect


@pytest.mark.parametrize("op", ["join", "aggregate", "sort", "scan",
                                "segmented_scan", "top_k"])
def test_mesh_programs_built_once(mesh8, op):
    """A second call with the same shapes and plan reuses every shard_map
    program (no new jit, so nothing re-traces)."""
    from cl_ops_tpu.parallel.mesh import mesh_program
    rng = np.random.RandomState(40)
    n = 8 * 256
    keys = rng.randint(0, 64, size=n).astype(np.uint32)
    vals = rng.randint(0, 50, size=n).astype(np.int32)
    calls = {
        "join": lambda: parallel.dist_hash_join(
            keys[:8 * 32], vals[:8 * 32], keys, mesh8, capacity_build=64,
            capacity_probe=n),
        "aggregate": lambda: parallel.dist_group_aggregate(
            keys, vals, mesh8, num_groups=64, capacity=n, agg="sum"),
        "sort": lambda: parallel.dist_sort(keys, mesh8),
        "scan": lambda: parallel.dist_scan(keys, mesh8, sum_dtype=np.uint64),
        "segmented_scan": lambda: parallel.dist_segmented_scan(
            vals, (keys == 0).astype(np.int32), mesh8),
        "top_k": lambda: parallel.dist_top_k(vals, 5, mesh8, keys),
    }
    first = jax.block_until_ready(calls[op]())
    built = mesh_program.cache_info().misses
    again = jax.block_until_ready(calls[op]())
    assert mesh_program.cache_info().misses == built
    for a, b in zip(jax.tree_util.tree_leaves(first),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_plan_splitters_balance(mesh8):
    """Skew-aware splitters balance Zipf-like keys."""
    from cl_ops_tpu.parallel.splitters import plan_splitters
    import jax.numpy as jnp
    rng = np.random.default_rng(40)
    # heavy skew: zipf-ish via exponential of exponential
    x = (rng.zipf(1.3, size=8 * 1024) % (1 << 20)).astype(np.uint32)
    spl = np.asarray(plan_splitters(jnp.asarray(x), mesh8))
    assert len(spl) == 7
    parts = np.searchsorted(spl, x)
    counts = np.bincount(parts, minlength=8)
    # balanced within 3x of uniform (hash partitioning on this data gives
    # one partition ~half the rows)
    assert counts.max() < 3 * (len(x) / 8)


def test_dist_sort_sample(mesh8):
    from cl_ops_tpu.parallel.splitters import dist_sort_sample
    import jax.numpy as jnp
    rng = np.random.RandomState(41)
    x = rng.randint(0, 1 << 30, size=8 * 1024, dtype=np.int64).astype(np.uint32)
    totals, buf, dropped = dist_sort_sample(jnp.asarray(x), mesh8,
                                            capacity_factor=4.0)
    assert int(np.asarray(dropped).sum()) == 0
    totals = np.asarray(totals).reshape(8)
    buf = np.asarray(buf).reshape(8, -1)
    got = np.concatenate([buf[c, :totals[c]] for c in range(8)])
    np.testing.assert_array_equal(got, np.sort(x))

def test_dist_group_aggregate_extreme_keys(mesh8):
    """Regression: validity was a key-space sentinel; -1 / 0xFFFFFFFF keys
    must aggregate correctly even with partially-filled shuffle buckets."""
    from cl_ops_tpu.parallel.aggregate import dist_group_aggregate
    import jax.numpy as jnp
    rng = np.random.RandomState(32)
    n = 8 * 256
    for dt, keyset in ((np.int32, (-1, -5, 3, 7)),
                       (np.uint32, (0xFFFFFFFF, 1, 2))):
        keys = rng.choice(np.array(keyset, dt), size=n)
        vals = rng.randint(1, 10, size=n).astype(np.int32)
        gk, table, cnt = dist_group_aggregate(
            jnp.asarray(keys), jnp.asarray(vals), mesh8,
            num_groups=64, capacity=n, agg="sum")
        gk = np.asarray(gk).reshape(8, 64)
        table = np.asarray(table).reshape(8, 64)
        cnt = np.asarray(cnt).reshape(8)
        got = {}
        for c in range(8):
            for i in range(cnt[c]):
                got[int(gk[c, i])] = int(table[c, i])
        expect = {int(k): int(vals[keys == k].sum()) for k in np.unique(keys)}
        assert got == expect, dt


def test_dist_hash_join_max_key(mesh8):
    """Regression: a real key equal to the old -1 sentinel must join."""
    from cl_ops_tpu.parallel.join import dist_hash_join
    import jax.numpy as jnp
    rng = np.random.RandomState(33)
    dim_keys = np.array([0xFFFFFFFF, 1, 2, 3, 4, 5, 6, 7], np.uint32)
    dim_vals = np.arange(8, dtype=np.uint32) + 100
    fact = rng.choice(np.array([0xFFFFFFFF, 1, 2, 9], np.uint32), size=8 * 8)
    found, vals = dist_hash_join(
        jnp.asarray(dim_keys), jnp.asarray(dim_vals), jnp.asarray(fact),
        mesh8, capacity_build=8, capacity_probe=len(fact))
    found, vals = np.asarray(found), np.asarray(vals)
    expect = np.isin(fact, dim_keys)
    np.testing.assert_array_equal(found, expect)
    lut = {int(k): int(v) for k, v in zip(dim_keys, dim_vals)}
    for i in np.nonzero(expect)[0]:
        assert int(vals[i]) == lut[int(fact[i])]


def test_dist_sort_sample_signed_keys(mesh8):
    """Regression: signed keys (-1 sorts mid-array) with the old key-space
    pad sentinel corrupted the sorted prefix."""
    from cl_ops_tpu.parallel.splitters import dist_sort_sample
    import jax.numpy as jnp
    rng = np.random.RandomState(42)
    x = rng.randint(-(1 << 20), 1 << 20, size=8 * 512).astype(np.int32)
    totals, buf, dropped = dist_sort_sample(jnp.asarray(x), mesh8,
                                            capacity_factor=4.0)
    assert int(np.asarray(dropped).sum()) == 0
    totals = np.asarray(totals).reshape(8)
    buf = np.asarray(buf).reshape(8, -1)
    got = np.concatenate([buf[c, :totals[c]] for c in range(8)])
    np.testing.assert_array_equal(got, np.sort(x))


def test_dist_hash_join_non_unique_and_semi(mesh8):
    from cl_ops_tpu.parallel.join import dist_hash_join
    import jax.numpy as jnp
    rng = np.random.RandomState(34)
    build = rng.randint(0, 32, size=8 * 32).astype(np.uint32)
    bvals = (build * 100).astype(np.int32)  # value determined by key
    probe = rng.randint(0, 48, size=8 * 64).astype(np.uint32)
    cnt, fv = dist_hash_join(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe), mesh8,
        capacity_build=len(build), capacity_probe=len(probe),
        unique_build=False)
    cnt, fv = np.asarray(cnt), np.asarray(fv)
    for i in range(len(probe)):
        assert cnt[i] == (build == probe[i]).sum(), i
        if cnt[i]:
            assert fv[i] == probe[i] * 100, i
    semi = dist_hash_join(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe), mesh8,
        capacity_build=len(build), capacity_probe=len(probe),
        join_type="semi")
    np.testing.assert_array_equal(np.asarray(semi), np.isin(probe, build))
    anti = dist_hash_join(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe), mesh8,
        capacity_build=len(build), capacity_probe=len(probe),
        join_type="anti")
    np.testing.assert_array_equal(np.asarray(anti), ~np.isin(probe, build))


def test_dist_hash_join_zipf_replan(mesh8):
    """Zipf(1.2) probe keys whose uniform-share buckets overflow: the join
    must re-plan (hash -> range splitters -> doubled capacity), return the
    exact answer, and lose zero rows (r2 VERDICT item 1)."""
    from cl_ops_tpu.parallel.join import dist_hash_join
    from cl_ops_tpu.parallel.shuffle import partition_exchange
    from cl_ops_tpu.parallel.splitters import hash_partition_ids
    import jax.numpy as jnp
    rng = np.random.default_rng(50)
    n = 8 * 1024
    probe = (rng.zipf(1.2, size=n) % (1 << 16)).astype(np.uint32)
    nb = 8 * 64
    dim_keys = np.arange(nb, dtype=np.uint32)  # covers the heavy low keys
    dim_vals = (dim_keys * 5 + 3).astype(np.int32)
    cap_probe = (n // 8) // 8  # exactly the uniform share: no headroom
    # prove adversarial: the plain hash shuffle at this capacity drops rows
    pid = hash_partition_ids(jnp.asarray(probe), 8)
    _, dropped, _ = partition_exchange(jnp.asarray(probe), pid, mesh8,
                                       capacity=cap_probe)
    assert int(np.asarray(dropped).sum()) > 0, "case must overflow hash"
    found, vals = dist_hash_join(
        jnp.asarray(dim_keys), jnp.asarray(dim_vals), jnp.asarray(probe),
        mesh8, capacity_build=nb, capacity_probe=cap_probe,
        samples_per_chip=64)
    found, vals = np.asarray(found), np.asarray(vals)
    expect = probe < nb
    np.testing.assert_array_equal(found, expect)
    np.testing.assert_array_equal(vals[expect],
                                  (probe[expect] * 5 + 3).astype(np.int32))


def test_dist_hash_join_overflow_raises(mesh8):
    """Persistent overflow (one dominant key, no replan budget) must raise,
    never silently drop rows."""
    from cl_ops_tpu.parallel.join import dist_hash_join
    import jax.numpy as jnp
    n = 8 * 64
    probe = np.full(n, 7, np.uint32)  # one key: unsplittable by design
    dim_keys = np.arange(8, dtype=np.uint32)
    dim_vals = dim_keys.astype(np.int32)
    with pytest.raises(RuntimeError, match="overflow persists"):
        dist_hash_join(jnp.asarray(dim_keys), jnp.asarray(dim_vals),
                       jnp.asarray(probe), mesh8, capacity_build=8,
                       capacity_probe=8, max_replan=1)


def test_dist_group_aggregate_zipf_replan(mesh8):
    from cl_ops_tpu.parallel.aggregate import dist_group_aggregate
    import jax.numpy as jnp
    rng = np.random.default_rng(51)
    n = 8 * 1024
    keys = (rng.zipf(1.2, size=n) % 4096).astype(np.uint32)
    vals = rng.integers(1, 9, size=n).astype(np.int32)
    cap = (n // 8) // 8  # uniform share, overflows under the Zipf head
    gk, table, cnt = dist_group_aggregate(
        jnp.asarray(keys), jnp.asarray(vals), mesh8,
        num_groups=4096, capacity=cap, agg="sum", samples_per_chip=64)
    gk = np.asarray(gk).reshape(8, -1)
    table = np.asarray(table).reshape(8, -1)
    cnt = np.asarray(cnt).reshape(8)
    got = {}
    for c in range(8):
        for i in range(cnt[c]):
            got[int(gk[c, i])] = int(table[c, i])
    expect = {int(k): int(vals[keys == k].sum()) for k in np.unique(keys)}
    assert got == expect


def test_dist_hash_join_edge_keys(mesh8):
    """The local sorted-table search, incl. the 0 and 0xFFFFFFFF edge
    keys."""
    from cl_ops_tpu.parallel.join import dist_hash_join
    import jax.numpy as jnp
    rng = np.random.RandomState(52)
    dim_keys = np.unique(np.concatenate([
        rng.randint(0, 1 << 20, size=300).astype(np.uint32),
        np.array([0xFFFFFFFF, 0], np.uint32)]))
    nb = (len(dim_keys) // 8) * 8
    dim_keys = dim_keys[:nb]
    dim_vals = (dim_keys * 3 + 1).astype(np.uint32)
    fact = np.concatenate([
        dim_keys[rng.randint(0, nb, size=8 * 100)],
        np.full(8, 0xFFFFFFFF, np.uint32),
        rng.randint(1 << 20, 1 << 21, size=8 * 27).astype(np.uint32)])
    rng.shuffle(fact)
    for unique_build in (True, False):
        out = dist_hash_join(
            jnp.asarray(dim_keys), jnp.asarray(dim_vals), jnp.asarray(fact),
            mesh8, capacity_build=nb, capacity_probe=len(fact), unique_build=unique_build)
        got, vals = np.asarray(out[0]), np.asarray(out[1])
        expect = np.isin(fact, dim_keys)
        if unique_build:
            np.testing.assert_array_equal(got, expect)
        else:
            np.testing.assert_array_equal(got > 0, expect)
        np.testing.assert_array_equal(vals[expect], fact[expect] * 3 + 1)


def test_dist_group_aggregate_edge_keys(mesh8):
    from cl_ops_tpu.parallel.aggregate import dist_group_aggregate
    import jax.numpy as jnp
    rng = np.random.RandomState(53)
    n = 8 * 256
    keys = rng.choice(np.array([0xFFFFFFFF, 1, 2, 77], np.uint32), size=n)
    vals = rng.randint(1, 10, size=n).astype(np.int32)
    gk, table, cnt = dist_group_aggregate(
        jnp.asarray(keys), jnp.asarray(vals), mesh8,
        num_groups=64, capacity=n, agg="sum")
    gk = np.asarray(gk).reshape(8, 64)
    table = np.asarray(table).reshape(8, 64)
    cnt = np.asarray(cnt).reshape(8)
    got = {}
    for c in range(8):
        for i in range(cnt[c]):
            got[int(gk[c, i])] = int(table[c, i])
    expect = {int(k): int(vals[keys == k].sum()) for k in np.unique(keys)}
    assert got == expect


def test_dist_hash_join_range_partition(mesh8):
    """partition='range' opener: splitters sampled from the probe side."""
    from cl_ops_tpu.parallel.join import dist_hash_join
    import jax.numpy as jnp
    rng = np.random.RandomState(54)
    nb = 8 * 32
    dim_keys = np.arange(nb, dtype=np.uint32) * 3
    dim_vals = (dim_keys + 9).astype(np.int32)
    fact = rng.randint(0, 3 * nb, size=8 * 128).astype(np.uint32)
    found, vals = dist_hash_join(
        jnp.asarray(dim_keys), jnp.asarray(dim_vals), jnp.asarray(fact),
        mesh8, capacity_build=nb, capacity_probe=8 * 128,
        partition="range", samples_per_chip=32)
    found, vals = np.asarray(found), np.asarray(vals)
    expect = fact % 3 == 0
    np.testing.assert_array_equal(found, expect)
    np.testing.assert_array_equal(vals[expect],
                                  (fact[expect] + 9).astype(np.int32))


def test_dist_hash_join_expand(mesh8):
    """Distributed full expansion: partition-sharded (probe row, value)
    pairs, multiset-exact vs the numpy oracle, truncation reported."""
    from cl_ops_tpu.parallel.join import dist_hash_join_expand
    import jax.numpy as jnp
    rng = np.random.RandomState(60)
    nb = 8 * 64
    build = np.sort(rng.randint(0, 200, size=nb).astype(np.uint32))
    bvals = np.arange(nb, dtype=np.int32) + 7
    probe = rng.randint(0, 256, size=8 * 128).astype(np.uint32)
    cap_out = 4096
    totals, pidx, vals = dist_hash_join_expand(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe), mesh8,
        capacity_build=nb, capacity_probe=len(probe), capacity_out=cap_out)
    totals = np.asarray(totals).reshape(8)
    pidx = np.asarray(pidx).reshape(8, cap_out)
    vals = np.asarray(vals).reshape(8, cap_out)
    got = []
    for c in range(8):
        t = totals[c]
        assert t <= cap_out, "test capacity must not truncate"
        got.extend(zip(pidx[c, :t].tolist(), vals[c, :t].tolist()))
    expect = []
    for i, p in enumerate(probe):
        for b, v in zip(build, bvals):
            if b == p:
                expect.append((i, int(v)))
    assert sorted(got) == sorted(expect)


def test_dist_hash_join_expand_truncation_reported(mesh8):
    from cl_ops_tpu.parallel.join import dist_hash_join_expand
    import jax.numpy as jnp
    build = np.zeros(8 * 8, np.uint32)      # every probe matches all 64
    bvals = np.arange(8 * 8, dtype=np.int32)
    probe = np.zeros(8 * 8, np.uint32)
    totals, pidx, vals = dist_hash_join_expand(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe), mesh8,
        capacity_build=64, capacity_probe=64, capacity_out=128)
    totals = np.asarray(totals).reshape(8)
    assert totals.sum() == 64 * 64          # true total reported
    assert totals.max() > 128               # truncation visible per chip


def test_keyed_exchange_replan_reuses_clean_sides(mesh8):
    """Capacity-doubling rounds keep the plan fixed: sides that did not
    overflow must NOT re-run their all_to_all shuffle."""
    import jax.numpy as jnp
    from cl_ops_tpu.parallel import splitters as sp
    rng = np.random.default_rng(70)
    n = 8 * 512
    heavy = (rng.zipf(1.1, size=n) % 256).astype(np.uint32)  # overflows
    light = np.arange(8 * 64, dtype=np.uint32)               # never does
    calls = []
    orig = sp.partition_exchange

    def counting(data, pid, mesh, **kw):
        calls.append(data.shape[0])
        return orig(data, pid, mesh, **kw)

    sp.partition_exchange = counting
    try:
        (lres, hres), caps = sp.keyed_exchange_replan(
            [(jnp.asarray(light), ()), (jnp.asarray(heavy), ())], mesh8,
            capacities=(len(light), (n // 8) // 8), max_replan=6,
            samples_per_chip=16, splitter_side=1)
    finally:
        sp.partition_exchange = orig
    # attempts: hash, range, resample = 3 plan versions -> light runs <= 3
    # times; every further (caps-doubling) attempt re-runs ONLY heavy
    light_calls = sum(1 for c in calls if c == len(light))
    heavy_calls = sum(1 for c in calls if c == n)
    assert light_calls <= 3, calls
    assert heavy_calls >= light_calls
    assert caps[0] == len(light)  # clean side's capacity untouched


def test_dist_hash_join_defer_jit(mesh8):
    """check="defer" is jit-traceable, matches the replan path, and
    returns all-zero dropped counters when capacities suffice."""
    import jax.numpy as jnp
    from cl_ops_tpu.parallel.join import dist_hash_join
    rng = np.random.RandomState(80)
    nb = 8 * 64
    bk = rng.permutation(nb).astype(np.int32)
    bv = (bk * 2 + 1).astype(np.int32)
    pk = rng.randint(0, 2 * nb, size=8 * 256).astype(np.int32)
    fn = jax.jit(lambda b, v, p: dist_hash_join(
        b, v, p, mesh8, capacity_build=nb, capacity_probe=len(pk), check="defer"))
    found, vals, dropped = fn(jnp.asarray(bk), jnp.asarray(bv),
                              jnp.asarray(pk))
    assert all(int(np.asarray(d).sum()) == 0 for d in dropped)
    expect = pk < nb
    np.testing.assert_array_equal(np.asarray(found), expect)
    np.testing.assert_array_equal(np.asarray(vals)[expect],
                                  pk[expect] * 2 + 1)


def test_dist_hash_join_defer_reports_overflow(mesh8):
    """Undersized capacities must surface in the deferred counters —
    never raise, never silently pass."""
    import jax.numpy as jnp
    from cl_ops_tpu.parallel.join import dist_hash_join
    pk = np.zeros(8 * 64, np.int32)  # every probe row -> one partition
    out = dist_hash_join(
        jnp.asarray(np.arange(8 * 8, dtype=np.int32)),
        jnp.asarray(np.zeros(8 * 8, np.int32)), jnp.asarray(pk), mesh8,
        capacity_build=64, capacity_probe=4,
        check="defer")
    dropped = out[-1]
    assert int(np.asarray(dropped[1]).sum()) > 0


def test_dist_group_aggregate_defer_jit(mesh8):
    import jax.numpy as jnp
    from cl_ops_tpu.parallel.aggregate import dist_group_aggregate
    rng = np.random.RandomState(81)
    n = 8 * 512
    keys = rng.randint(0, 100, size=n).astype(np.int32)
    vals = rng.randint(0, 50, size=n).astype(np.int32)
    fn = jax.jit(lambda k, v: dist_group_aggregate(
        k, v, mesh8, num_groups=256, capacity=n, agg="sum", check="defer"))
    gk, table, cnt, dropped = fn(jnp.asarray(keys), jnp.asarray(vals))
    assert int(np.asarray(dropped).sum()) == 0
    got = {}
    gk, table, cnt = np.asarray(gk), np.asarray(table), np.asarray(cnt)
    per = len(gk) // 8
    for c in range(8):
        for i in range(int(cnt[c])):
            got[int(gk[c * per + i])] = int(table[c * per + i])
    expect = {int(k): int(vals[keys == k].sum()) for k in np.unique(keys)}
    assert got == expect


@pytest.mark.parametrize("partition", ["hash", "range"])
def test_dist_group_aggregate_cols(mesh8, partition):
    """Multi-measure distributed GROUP BY: one shuffle carries every
    measure, every agg matches the numpy oracle under either partition
    plan."""
    import jax.numpy as jnp
    from cl_ops_tpu.parallel.aggregate import dist_group_aggregate_cols
    rng = np.random.RandomState(83)
    n = 8 * 512
    keys = rng.randint(0, 60, size=n).astype(np.int32)
    v1 = rng.randint(-40, 40, size=n).astype(np.int32)
    v2 = rng.randint(0, 100, size=n).astype(np.int32)
    gk, (s1, mn1, mx2, c2), cnt = dist_group_aggregate_cols(
        jnp.asarray(keys), (jnp.asarray(v1), jnp.asarray(v1),
                            jnp.asarray(v2), jnp.asarray(v2)),
        ("sum", "min", "max", "count"), mesh8, num_groups=128,
        capacity=n, partition=partition)
    gk, cnt = np.asarray(gk), np.asarray(cnt)
    s1, mn1, mx2, c2 = (np.asarray(x) for x in (s1, mn1, mx2, c2))
    per = len(gk) // 8
    got = {}
    for c in range(8):
        for i in range(int(cnt[c])):
            j = c * per + i
            got[int(gk[j])] = (int(s1[j]), int(mn1[j]), int(mx2[j]),
                               int(c2[j]))
    expect = {int(k): (int(v1[keys == k].sum()), int(v1[keys == k].min()),
                       int(v2[keys == k].max()), int((keys == k).sum()))
              for k in np.unique(keys)}
    assert got == expect


def test_dist_group_aggregate_cols_defer_jit(mesh8):
    """check="defer" keeps the multi-measure form jit-traceable."""
    import jax.numpy as jnp
    from cl_ops_tpu.parallel.aggregate import dist_group_aggregate_cols
    rng = np.random.RandomState(84)
    n = 8 * 256
    keys = rng.randint(0, 40, size=n).astype(np.int32)
    v1 = rng.randint(0, 50, size=n).astype(np.int32)
    fn = jax.jit(lambda k, a: dist_group_aggregate_cols(
        k, (a, a), ("sum", "mean"), mesh8, num_groups=64, capacity=n, check="defer"))
    gk, (s1, m1), cnt, dropped = fn(jnp.asarray(keys), jnp.asarray(v1))
    assert int(np.asarray(dropped).sum()) == 0
    gk, cnt = np.asarray(gk), np.asarray(cnt)
    s1, m1 = np.asarray(s1), np.asarray(m1)
    per = len(gk) // 8
    for c in range(8):
        for i in range(int(cnt[c])):
            j = c * per + i
            k = int(gk[j])
            assert int(s1[j]) == int(v1[keys == k].sum())
            assert abs(float(m1[j]) - v1[keys == k].mean()) < 1e-3
    with pytest.raises(ValueError, match="equal-length"):
        dist_group_aggregate_cols(jnp.asarray(keys), (jnp.asarray(v1),),
                                  ("sum", "min"), mesh8, num_groups=8,
                                  capacity=n)


def test_dist_hash_join_expand_defer(mesh8):
    import jax.numpy as jnp
    from cl_ops_tpu.parallel.join import dist_hash_join_expand
    rng = np.random.RandomState(82)
    nb = 8 * 32
    bk = np.repeat(np.arange(nb // 2, dtype=np.int32), 2)  # 2 dups/key
    bv = np.arange(nb, dtype=np.int32)
    pk = rng.randint(0, nb // 2, size=8 * 64).astype(np.int32)
    args = (jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk))
    kw = dict(capacity_build=nb, capacity_probe=len(pk), capacity_out=1024)
    t1, p1, v1 = dist_hash_join_expand(*args, mesh8, **kw)
    fn = jax.jit(lambda b, v, p: dist_hash_join_expand(
        b, v, p, mesh8, **kw, check="defer"))
    t2, p2, v2, dropped = fn(*args)
    assert all(int(np.asarray(d).sum()) == 0 for d in dropped)
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


def test_dist_join_bad_check_rejected(mesh8):
    import jax.numpy as jnp
    from cl_ops_tpu.parallel.aggregate import dist_group_aggregate
    from cl_ops_tpu.parallel.join import dist_hash_join
    a = jnp.asarray(np.zeros(8, np.int32))
    with pytest.raises(ValueError):
        dist_hash_join(a, a, a, mesh8, capacity_build=8, capacity_probe=8,
                       check="nope")
    with pytest.raises(ValueError):
        dist_group_aggregate(a, a, mesh8, num_groups=8, capacity=8,
                             check="nope")
