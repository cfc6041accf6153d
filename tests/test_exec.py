"""Query-operator tests (filter / aggregate / join) vs numpy oracles."""

import numpy as np
import pytest

import jax.numpy as jnp

from cl_ops_tpu.ops import exec as ex


def test_filter_compact():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 1000, size=5000).astype(np.int32)
    pred = lambda d: (d % 10) == 0  # noqa: E731
    count, packed = ex.filter_compact(jnp.asarray(x), pred)
    keep = x[(x % 10) == 0]
    assert int(count) == len(keep)
    np.testing.assert_array_equal(np.asarray(packed)[:int(count)], keep)


def test_filter_compact_extra_cols():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 100, size=2000).astype(np.int32)
    v = np.arange(2000, dtype=np.float32)
    pred = lambda d: d < 10  # noqa: E731
    count, px, pv = ex.filter_compact(jnp.asarray(x), pred, jnp.asarray(v))
    m = x < 10
    assert int(count) == m.sum()
    np.testing.assert_array_equal(np.asarray(px)[:int(count)], x[m])
    np.testing.assert_array_equal(np.asarray(pv)[:int(count)], v[m])


def test_filter_pallas_path():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 100, size=3000).astype(np.int32)
    pred = lambda d: d >= 50  # noqa: E731
    count, packed = ex.filter_compact(jnp.asarray(x), pred)
    keep = x[x >= 50]
    assert int(count) == len(keep)
    np.testing.assert_array_equal(np.asarray(packed)[:int(count)], keep)


def test_count_where():
    x = np.arange(100, dtype=np.int32)
    assert int(ex.count_where(jnp.asarray(x), lambda d: d < 30)) == 30


@pytest.mark.parametrize("agg,oracle", [
    ("sum", np.sum), ("count", len), ("min", np.min), ("max", np.max),
    ("mean", np.mean)])
def test_group_aggregate_direct(agg, oracle):
    rng = np.random.RandomState(3)
    g = rng.randint(0, 50, size=4000).astype(np.int32)
    v = rng.randint(1, 100, size=4000).astype(np.int32)
    vv = v.astype(np.float32) if agg == "mean" else v
    table = ex.group_aggregate_direct(jnp.asarray(g), jnp.asarray(vv),
                                      num_groups=50, agg=agg)
    for grp in range(50):
        sel = vv[g == grp]
        if len(sel) == 0:
            continue
        np.testing.assert_allclose(np.asarray(table)[grp], oracle(sel),
                                   rtol=1e-6)


def test_group_aggregate_sorted():
    rng = np.random.RandomState(4)
    keys = rng.randint(0, 1 << 30, size=3000).astype(np.uint32)
    keys = keys[rng.randint(0, 3000, size=3000)]  # force duplicates
    vals = rng.randint(0, 100, size=3000).astype(np.int32)
    gkeys, table, count = ex.group_aggregate_sorted(
        jnp.asarray(keys), jnp.asarray(vals), num_groups=3000)
    uniq = np.unique(keys)
    assert int(count) == len(uniq)
    np.testing.assert_array_equal(np.asarray(gkeys)[:len(uniq)], uniq)
    expect = np.array([vals[keys == k].sum() for k in uniq])
    np.testing.assert_array_equal(np.asarray(table)[:len(uniq)], expect)


def test_hash_join():
    rng = np.random.RandomState(5)
    dim_keys = np.unique(rng.randint(0, 1 << 20, size=500).astype(np.uint32))
    dim_vals = (dim_keys * 7).astype(np.uint32)
    perm = rng.permutation(len(dim_keys))
    fact_keys = np.concatenate([
        dim_keys[rng.randint(0, len(dim_keys), size=2000)],
        (rng.randint(1 << 20, 1 << 21, size=100)).astype(np.uint32)])
    found, vals = ex.hash_join(jnp.asarray(dim_keys[perm]),
                               jnp.asarray(dim_vals[perm]),
                               jnp.asarray(fact_keys))
    found, vals = np.asarray(found), np.asarray(vals)
    expect_found = np.isin(fact_keys, dim_keys)
    np.testing.assert_array_equal(found, expect_found)
    np.testing.assert_array_equal(vals[expect_found],
                                  fact_keys[expect_found] * 7)


def test_hash_u32_range():
    x = jnp.asarray(np.arange(10000, dtype=np.uint32))
    h = np.asarray(ex.hash_u32(x, 8))
    assert h.min() >= 0 and h.max() < 256
    # roughly uniform: every bucket hit
    assert len(np.unique(h)) == 256


def test_filter_pallas_extra_cols_float():
    """Compaction with a float payload column."""
    rng = np.random.RandomState(6)
    x = rng.randint(0, 100, size=1500).astype(np.int32)
    v = rng.randn(1500).astype(np.float32)
    pred = lambda d: d % 3 == 0  # noqa: E731
    count, px, pv = ex.filter_compact(jnp.asarray(x), pred, jnp.asarray(v))
    m = x % 3 == 0
    assert int(count) == m.sum()
    np.testing.assert_array_equal(np.asarray(px)[:int(count)], x[m])
    np.testing.assert_array_equal(np.asarray(pv)[:int(count)], v[m])


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max", "mean"])
@pytest.mark.parametrize("n", [1200, 6000])
def test_group_aggregate_sorted_all_aggs(agg, n):
    """Every agg; n=1200 takes the dense-groups end form, n=6000 the
    two-level search over more than one 4096-row block."""
    rng = np.random.RandomState(7)
    keys = rng.randint(0, 40, size=n).astype(np.uint32)
    vals = rng.randint(-50, 50, size=n).astype(np.int32)
    vv = vals.astype(np.float32) if agg == "mean" else vals
    gkeys, table, count = ex.group_aggregate_sorted(
        jnp.asarray(keys), jnp.asarray(vv), num_groups=64, agg=agg)
    uniq = np.unique(keys)
    assert int(count) == len(uniq)
    np.testing.assert_array_equal(np.asarray(gkeys)[:len(uniq)], uniq)
    oracle = {"sum": np.sum, "count": len, "min": np.min, "max": np.max,
              "mean": np.mean}[agg]
    expect = np.array([oracle(vv[keys == k]) for k in uniq])
    np.testing.assert_allclose(np.asarray(table)[:len(uniq)], expect,
                               rtol=1e-6)


def test_group_aggregate_sorted_u64_keys():
    """64-bit keys ride two limbs through the column sort."""
    rng = np.random.RandomState(8)
    base = rng.randint(0, 1 << 62, size=12, dtype=np.uint64) * 4
    base[0] = np.uint64(2**64 - 1)  # top-bit key exercises high-limb flip
    keys = base[rng.randint(0, 12, size=600)]
    vals = rng.randint(0, 100, size=600).astype(np.int32)
    gkeys, table, count = ex.group_aggregate_sorted(
        jnp.asarray(keys), jnp.asarray(vals), num_groups=32, agg="sum")
    uniq = np.unique(keys)
    assert int(count) == len(uniq)
    np.testing.assert_array_equal(np.asarray(gkeys)[:len(uniq)], uniq)
    expect = np.array([vals[keys == k].sum() for k in uniq])
    np.testing.assert_array_equal(np.asarray(table)[:len(uniq)], expect)


@pytest.mark.parametrize("probe_impl", ["direct", "merge"])
def test_hash_join_paths(probe_impl):
    rng = np.random.RandomState(9)
    dim_keys = np.unique(rng.randint(0, 1 << 16, size=300).astype(np.uint32))
    dim_vals = (dim_keys * 13 + 5).astype(np.uint32)
    perm = rng.permutation(len(dim_keys))
    fact = np.concatenate([
        dim_keys[rng.randint(0, len(dim_keys), size=900)],
        rng.randint(1 << 16, 1 << 17, size=77).astype(np.uint32)])
    rng.shuffle(fact)
    found, vals = ex.hash_join(jnp.asarray(dim_keys[perm]),
                               jnp.asarray(dim_vals[perm]),
                               jnp.asarray(fact), probe_impl=probe_impl)
    found, vals = np.asarray(found), np.asarray(vals)
    expect = np.isin(fact, dim_keys)
    np.testing.assert_array_equal(found, expect)
    np.testing.assert_array_equal(vals[expect], fact[expect] * 13 + 5)


def test_hash_join_float_vals_pallas():
    """4-byte float build values ride the probe as bitcast columns."""
    rng = np.random.RandomState(10)
    dim_keys = np.arange(64, dtype=np.uint32)
    dim_vals = rng.randn(64).astype(np.float32)
    fact = rng.randint(0, 80, size=500).astype(np.uint32)
    found, vals = ex.hash_join(jnp.asarray(dim_keys), jnp.asarray(dim_vals),
                               jnp.asarray(fact))
    found, vals = np.asarray(found), np.asarray(vals)
    np.testing.assert_array_equal(found, fact < 64)
    np.testing.assert_array_equal(vals[found], dim_vals[fact[found]])


@pytest.mark.parametrize("probe_impl", ["direct", "merge"])
def test_hash_join_non_unique(probe_impl):
    """Duplicate build keys: (match_count, first_val in sorted order)."""
    rng = np.random.RandomState(12)
    build = rng.randint(0, 64, size=500).astype(np.uint32)
    bvals = np.arange(500, dtype=np.int32)
    probe = rng.randint(0, 80, size=700).astype(np.uint32)
    count, fv = ex.hash_join(jnp.asarray(build), jnp.asarray(bvals),
                             jnp.asarray(probe), unique_build=False,
                             probe_impl=probe_impl)
    count, fv = np.asarray(count), np.asarray(fv)
    order = np.argsort(build, kind="stable")
    sb, sv = build[order], bvals[order]
    for i in range(len(probe)):
        matches = sv[sb == probe[i]]
        assert count[i] == len(matches), i
        if len(matches):
            assert fv[i] == matches[0], i


def test_hash_join_non_unique_extreme_keys():
    """Duplicates at the limb minimum and maximum."""
    build = np.array([0, 0, 0, 5, 5, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32)
    bvals = np.arange(7, dtype=np.int32) + 10
    probe = np.array([0, 5, 7, 0xFFFFFFFF], np.uint32)
    count, fv = ex.hash_join(jnp.asarray(build), jnp.asarray(bvals),
                             jnp.asarray(probe), build_sorted=True,
                             unique_build=False)
    np.testing.assert_array_equal(np.asarray(count), [3, 2, 0, 2])
    fv = np.asarray(fv)
    assert fv[0] == 10 and fv[1] == 13 and fv[3] == 15


@pytest.mark.parametrize("jt,expect_fn", [
    ("semi", lambda f: f), ("anti", lambda f: ~f)])
def test_hash_join_semi_anti(jt, expect_fn):
    rng = np.random.RandomState(13)
    dim = np.unique(rng.randint(0, 1000, size=200).astype(np.uint32))
    dv = dim.astype(np.int32)
    probe = rng.randint(0, 1500, size=400).astype(np.uint32)
    mask = ex.hash_join(jnp.asarray(dim), jnp.asarray(dv),
                        jnp.asarray(probe), join_type=jt)
    np.testing.assert_array_equal(np.asarray(mask),
                                  expect_fn(np.isin(probe, dim)))


def test_hash_join_u64_keys():
    """64-bit keys ride two limbs through the probe."""
    rng = np.random.RandomState(14)
    dim = np.unique((rng.randint(0, 1 << 30, size=100).astype(np.uint64)
                     << np.uint64(33)) | np.uint64(1))
    dim[0] = np.uint64(2**64 - 1)
    dim = np.unique(dim)
    dv = np.arange(len(dim), dtype=np.int32)
    probe = np.concatenate([dim[rng.randint(0, len(dim), size=300)],
                            rng.randint(0, 1000, size=50).astype(np.uint64)])
    found, vals = ex.hash_join(jnp.asarray(dim), jnp.asarray(dv),
                               jnp.asarray(probe))
    found, vals = np.asarray(found), np.asarray(vals)
    expect = np.isin(probe, dim)
    np.testing.assert_array_equal(found, expect)
    sdim = np.sort(dim)
    lut = {int(k): i for i, k in enumerate(sdim)}
    for i in np.nonzero(expect)[0]:
        assert vals[i] == lut[int(probe[i])]


@pytest.mark.parametrize("key_bits", [None, 5])
def test_group_aggregate_prefix(key_bits):
    """Aggregate only the valid prefix (filter_compact composition)."""
    rng = np.random.RandomState(15)
    keys = rng.randint(0, 20, size=1000).astype(np.int32)
    vals = rng.randint(1, 9, size=1000).astype(np.int32)
    n_valid = 617
    gk, table, cnt = ex.group_aggregate_prefix(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(n_valid),
        num_groups=32, agg="sum", key_bits=key_bits)
    kv, vv = keys[:n_valid], vals[:n_valid]
    uniq = np.unique(kv)
    assert int(cnt) == len(uniq)
    np.testing.assert_array_equal(np.asarray(gk)[:len(uniq)], uniq)
    np.testing.assert_array_equal(
        np.asarray(table)[:len(uniq)],
        [vv[kv == k].sum() for k in uniq])


@pytest.mark.parametrize("key_dtype", [np.uint32, np.int64])
def test_group_aggregate_cols(key_dtype):
    """Multi-measure GROUP BY (the TPC-H Q1 shape): one input sort, every
    agg on two measure columns against the numpy oracle. Column 0 rides
    the key order (min = boundary gather); column 2's max exercises the
    per-column (group_id, value) sort path."""
    rng = np.random.RandomState(70)
    n = 1 << 12
    keys = rng.randint(0, 200, size=n).astype(key_dtype)
    v1 = rng.randint(-50, 50, size=n).astype(np.int32)
    v2 = rng.randint(0, 1000, size=n).astype(np.uint32)
    a = (jnp.asarray(v1), jnp.asarray(v1), jnp.asarray(v2),
         jnp.asarray(v2), jnp.asarray(v2))
    gk, (mn1, s1, mx2, c2, mean2), cnt = ex.group_aggregate_cols(
        jnp.asarray(keys), a, ("min", "sum", "max", "count", "mean"),
        num_groups=256)
    uk = np.unique(keys)
    assert int(cnt) == len(uk)
    np.testing.assert_array_equal(np.asarray(gk)[:len(uk)], uk)
    mn1, s1, mx2, c2, mean2 = (np.asarray(x) for x in
                               (mn1, s1, mx2, c2, mean2))
    for g, k in enumerate(uk):
        m = keys == k
        assert int(mn1[g]) == int(v1[m].min())
        assert int(s1[g]) == int(v1[m].sum())
        assert int(mx2[g]) == int(v2[m].max())
        assert int(c2[g]) == int(m.sum())
        assert abs(float(mean2[g]) - v2[m].mean()) < 1e-3


def test_group_aggregate_cols_prefix_sorted_and_errors():
    """n_valid composes with filter_compact; keys_sorted consumes
    pre-grouped rows under jax.jit; invalid arguments reject."""
    import jax
    rng = np.random.RandomState(71)
    n = 1000
    keys = rng.randint(0, 30, size=n).astype(np.int32)
    v1 = rng.randint(1, 9, size=n).astype(np.int32)
    v2 = rng.randint(0, 100, size=n).astype(np.int32)
    n_valid = 617
    gk, (s1, mx2), cnt = ex.group_aggregate_cols(
        jnp.asarray(keys), (jnp.asarray(v1), jnp.asarray(v2)),
        ("sum", "max"), num_groups=64, n_valid=jnp.asarray(n_valid))
    kv = keys[:n_valid]
    uk = np.unique(kv)
    assert int(cnt) == len(uk)
    np.testing.assert_array_equal(np.asarray(gk)[:len(uk)], uk)
    np.testing.assert_array_equal(np.asarray(s1)[:len(uk)],
                                  [v1[:n_valid][kv == k].sum() for k in uk])
    np.testing.assert_array_equal(np.asarray(mx2)[:len(uk)],
                                  [v2[:n_valid][kv == k].max() for k in uk])
    # keys_sorted fusion path, whole call under jax.jit
    order = np.argsort(keys, kind="stable")
    fn = jax.jit(lambda k, a, b: ex.group_aggregate_cols(
        k, (a, b), ("sum", "min"), num_groups=64, keys_sorted=True))
    gk2, (s2, mn2), cnt2 = fn(jnp.asarray(keys[order]),
                              jnp.asarray(v1[order]),
                              jnp.asarray(v2[order]))
    uk2 = np.unique(keys)
    assert int(cnt2) == len(uk2)
    np.testing.assert_array_equal(np.asarray(s2)[:len(uk2)],
                                  [v1[keys == k].sum() for k in uk2])
    np.testing.assert_array_equal(np.asarray(mn2)[:len(uk2)],
                                  [v2[keys == k].min() for k in uk2])
    with pytest.raises(ValueError, match="equal-length"):
        ex.group_aggregate_cols(jnp.asarray(keys), (jnp.asarray(v1),),
                                ("sum", "max"), num_groups=64)
    with pytest.raises(ValueError, match="unknown agg"):
        ex.group_aggregate_cols(jnp.asarray(keys), (jnp.asarray(v1),),
                                ("median",), num_groups=64)
    with pytest.raises(ValueError, match="keys_sorted"):
        ex.group_aggregate_cols(jnp.asarray(keys), (jnp.asarray(v1),),
                                ("sum",), num_groups=64, keys_sorted=True,
                                n_valid=jnp.asarray(5))
    # empty input
    gk3, tbls, cnt3 = ex.group_aggregate_cols(
        jnp.asarray(np.zeros(0, np.int32)),
        (jnp.asarray(np.zeros(0, np.int32)),), ("sum",), num_groups=8)
    assert int(cnt3) == 0 and tbls[0].shape == (8,)


@pytest.mark.parametrize("key_dtype", [np.int32, np.uint64])
def test_group_aggregate_cols_valid_mask(key_dtype):
    """The fused WHERE + GROUP BY form: the boolean mask rides as the
    leading sort column, so a filtered multi-measure aggregate pays no
    separate filter_compact partition. min/max on non-first columns
    reduce through the segmented scan (signed i32 with negatives, u32
    above the sign bit, and f32 — plus an f16 column that must keep the
    sort path)."""
    rng = np.random.RandomState(72)
    n = 4000
    keys = rng.randint(0, 50, size=n).astype(key_dtype)
    v1 = rng.randint(-900, 900, size=n).astype(np.int32)
    v2 = (rng.randint(0, 1 << 32, size=n, dtype=np.uint64)
          .astype(np.uint32))
    v3 = rng.randn(n).astype(np.float32)
    v4 = rng.randn(n).astype(np.float16)
    mask = v1 < 300
    a = tuple(jnp.asarray(v) for v in (v1, v1, v2, v2, v3, v4))
    gk, (s1, mn1, mx2, mean2, mn3, mx4), cnt = ex.group_aggregate_cols(
        jnp.asarray(keys), a, ("sum", "min", "max", "mean", "min", "max"),
        num_groups=64, valid_mask=jnp.asarray(mask))
    uk = np.unique(keys[mask])
    assert int(cnt) == len(uk)
    np.testing.assert_array_equal(np.asarray(gk)[:len(uk)], uk)
    s1, mn1, mx2, mean2, mn3, mx4 = (np.asarray(x)[:len(uk)] for x in
                                     (s1, mn1, mx2, mean2, mn3, mx4))
    for g, k in enumerate(uk):
        m = mask & (keys == k)
        assert int(s1[g]) == int(np.int32(v1[m].sum()))
        assert int(mn1[g]) == int(v1[m].min())
        assert int(mx2[g]) == int(v2[m].max())
        exp_mean = float(np.uint32(v2[m].sum(dtype=np.uint64)
                                   & 0xFFFFFFFF)) / m.sum()
        assert abs(float(mean2[g]) - exp_mean) < max(1e-3 * exp_mean, 1e-3)
        assert float(mn3[g]) == float(v3[m].min())
        assert float(mx4[g]) == float(v4[m].max())
    with pytest.raises(ValueError, match="not both"):
        ex.group_aggregate_cols(
            jnp.asarray(keys), (jnp.asarray(v1),), ("sum",), num_groups=64,
            n_valid=jnp.asarray(5), valid_mask=jnp.asarray(mask))


@pytest.mark.parametrize("n", [5000, 777])
def test_group_aggregate_cols_key_bits(n):
    """key_bits WHERE-fusion packing: the validity bit rides above the
    key in one i32 sort column (caller contract: 0 <= key < 2^key_bits).
    Must match the unpacked form exactly, including keys AT the contract
    edge (2^key_bits - 1) and non-power-of-two row counts."""
    rng = np.random.RandomState(91)
    keys = rng.randint(0, 128, size=n).astype(np.uint32)
    keys[:17] = 127  # contract-edge keys present and valid
    qty = rng.randint(-500, 500, size=n).astype(np.int32)
    price = rng.randint(0, 10000, size=n).astype(np.int32)
    mask = qty < 300
    args = (jnp.asarray(keys),
            (jnp.asarray(qty), jnp.asarray(price), jnp.asarray(qty)),
            ("sum", "max", "min"))
    kw = dict(num_groups=256, valid_mask=jnp.asarray(mask))
    gk_p, t_p, c_p = ex.group_aggregate_cols(*args, key_bits=7, **kw)
    gk_u, t_u, c_u = ex.group_aggregate_cols(*args, **kw)
    assert int(c_p) == int(c_u)
    cnt = int(c_p)
    np.testing.assert_array_equal(np.asarray(gk_p)[:cnt],
                                  np.asarray(gk_u)[:cnt])
    for a, b in zip(t_p, t_u):
        np.testing.assert_array_equal(np.asarray(a)[:cnt],
                                      np.asarray(b)[:cnt])
    # n_valid form too
    nv = jnp.int32(n * 3 // 5)
    g2p = ex.group_aggregate_cols(
        jnp.asarray(keys), (jnp.asarray(qty),), ("sum",), num_groups=256,
        n_valid=nv, key_bits=7)
    g2u = ex.group_aggregate_cols(
        jnp.asarray(keys), (jnp.asarray(qty),), ("sum",), num_groups=256,
        n_valid=nv)
    assert int(g2p[2]) == int(g2u[2])
    np.testing.assert_array_equal(np.asarray(g2p[1][0])[:int(g2p[2])],
                                  np.asarray(g2u[1][0])[:int(g2u[2])])
    # bad hints are rejected loudly
    with pytest.raises(ValueError, match="key_bits"):
        ex.group_aggregate_cols(
            jnp.asarray(keys), (jnp.asarray(qty),), ("sum",),
            num_groups=256, valid_mask=jnp.asarray(mask), key_bits=31)
    with pytest.raises(ValueError, match="integer key"):
        ex.group_aggregate_cols(
            jnp.asarray(keys).astype(jnp.float32), (jnp.asarray(qty),),
            ("sum",), num_groups=256, valid_mask=jnp.asarray(mask),
            key_bits=7)


@pytest.mark.parametrize("G", [37, 200])
def test_group_aggregate_dense_cols(G):
    """Sort-free dense small-G aggregate: bit parity with the sorted path
    on every agg (wrapping i32 sums, u32 order, f32 min/max, masked rows,
    out-of-range ids dropped)."""
    rng = np.random.RandomState(73)
    n = 30000
    gid = rng.randint(-2, G + 2, n).astype(np.int32)
    v1 = rng.randint(-900, 900, n).astype(np.int32)
    v2 = (rng.randint(0, 1 << 32, n, dtype=np.int64)
          & 0xFFFFFFFF).astype(np.uint32)
    v3 = rng.randn(n).astype(np.float32)
    mask = v1 < 300
    gk, (s1, mn1, mx2, c, mn3), cnt = ex.group_aggregate_dense_cols(
        jnp.asarray(gid),
        tuple(jnp.asarray(x) for x in (v1, v1, v2, v1, v3)),
        ("sum", "min", "max", "count", "min"),
        num_groups=G, valid_mask=jnp.asarray(mask))
    ok = mask & (gid >= 0) & (gid < G)
    present = np.unique(gid[ok])
    cnt = int(cnt)
    assert cnt == len(present)
    np.testing.assert_array_equal(np.asarray(gk)[:cnt], present)
    for i, g in enumerate(present):
        m = ok & (gid == g)
        assert int(s1[i]) == int(np.int32(v1[m].sum()))
        assert int(mn1[i]) == int(v1[m].min())
        assert int(mx2[i]) == int(v2[m].max())
        assert int(c[i]) == int(m.sum())
        assert float(mn3[i]) == float(v3[m].min())
    with pytest.raises(ValueError, match="order-dependent"):
        ex.group_aggregate_dense_cols(
            jnp.asarray(gid), (jnp.asarray(v3),), ("sum",), num_groups=8)
    with pytest.raises(ValueError, match="64-bit"):
        ex.group_aggregate_dense_cols(
            jnp.asarray(gid), (jnp.asarray(v2.astype(np.uint64)),),
            ("max",), num_groups=8)


@pytest.mark.parametrize("probe_impl", ["auto", "direct", "merge"])
def test_hash_join_probe_impls(probe_impl):
    """All probe strategies agree with the oracle on the same data."""
    rng = np.random.RandomState(21)
    dim = np.unique(rng.randint(0, 1 << 20, size=800).astype(np.uint32))
    dv = (dim * 3 + 7).astype(np.int32)
    probe = np.concatenate([
        dim[rng.randint(0, len(dim), size=2000)],
        rng.randint(1 << 20, 1 << 21, size=500).astype(np.uint32)])
    rng.shuffle(probe)
    found, vals = ex.hash_join(jnp.asarray(dim), jnp.asarray(dv),
                               jnp.asarray(probe), build_sorted=True,
                               probe_impl=probe_impl)
    found, vals = np.asarray(found), np.asarray(vals)
    expect = np.isin(probe, dim)
    np.testing.assert_array_equal(found, expect)
    np.testing.assert_array_equal(vals[expect],
                                  (probe[expect] * 3 + 7).astype(np.int32))


def test_search_build_searchsorted_parity():
    """search_build == np.searchsorted(side='right') + match gathers."""
    from cl_ops_tpu.ops.exec.probe import search_build
    rng = np.random.RandomState(22)
    build = np.sort(rng.randint(0, 1 << 31, size=700).astype(np.int32))
    nb = len(build)
    vals = (np.arange(nb) * 5 + 2).astype(np.int32)
    probe = rng.randint(0, 1 << 31, size=3000).astype(np.int32)
    probe[:40] = build[rng.randint(0, nb, size=40)]
    probe[40] = 0x7FFFFFFF  # the i32 maximum
    probe[41] = -0x80000000  # the i32 minimum
    count, eq, (vp,), (vn,) = search_build(
        (jnp.asarray(build),), (jnp.asarray(vals),), (jnp.asarray(probe),))
    count, eq, vp, vn = (np.asarray(a) for a in (count, eq, vp, vn))
    exp_count = np.searchsorted(build, probe, side="right")
    np.testing.assert_array_equal(count, exp_count)
    np.testing.assert_array_equal(eq, np.isin(probe, build))
    np.testing.assert_array_equal(vp, vals[np.maximum(count - 1, 0)])
    np.testing.assert_array_equal(vn, vals[np.minimum(count, nb - 1)])


def test_search_build_two_limbs():
    from cl_ops_tpu.ops.exec.probe import search_build
    rng = np.random.RandomState(23)
    hi = rng.randint(-5, 5, size=400).astype(np.int32)
    lo = rng.randint(-9, 9, size=400).astype(np.int32)
    pairs = np.unique(np.stack([hi, lo], 1), axis=0)  # lex-sorted rows
    nb = len(pairs)
    v = np.arange(nb, dtype=np.int32)
    ph = rng.randint(-6, 6, size=1500).astype(np.int32)
    plo = rng.randint(-10, 10, size=1500).astype(np.int32)
    count, eq, _, _ = search_build(
        (jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])),
        (jnp.asarray(v),), (jnp.asarray(ph), jnp.asarray(plo)))
    count, eq = np.asarray(count), np.asarray(eq)
    key = pairs[:, 0].astype(np.int64) * 100 + pairs[:, 1]
    pk = ph.astype(np.int64) * 100 + plo
    np.testing.assert_array_equal(count, np.searchsorted(key, pk, "right"))
    np.testing.assert_array_equal(eq, np.isin(pk, key))


@pytest.mark.parametrize("nb", [1, 2, 3, 4096, 4097])
def test_search_build_step_count(nb):
    """The search takes nb.bit_length() halvings: probes at both ends of
    every build size land exactly (one step short would miss the last
    candidate)."""
    from cl_ops_tpu.ops.exec.probe import count_leq
    build = np.arange(nb, dtype=np.int32) * 2
    probe = np.array([-1, 0, 1, 2 * nb - 2, 2 * nb - 1, 2 * nb], np.int32)
    got = np.asarray(count_leq((jnp.asarray(build),), (jnp.asarray(probe),)))
    np.testing.assert_array_equal(got,
                                  np.searchsorted(build, probe, "right"))


@pytest.mark.parametrize("probe_impl", ["auto", "direct", "merge"])
def test_hash_join_non_unique_probe_impls(probe_impl):
    rng = np.random.RandomState(24)
    build = rng.randint(0, 64, size=600).astype(np.uint32)
    bvals = np.arange(600, dtype=np.int32)
    probe = rng.randint(0, 80, size=900).astype(np.uint32)
    count, fv = ex.hash_join(jnp.asarray(build), jnp.asarray(bvals),
                             jnp.asarray(probe), unique_build=False,
                             probe_impl=probe_impl)
    count, fv = np.asarray(count), np.asarray(fv)
    order = np.argsort(build, kind="stable")
    sb, sv = build[order], bvals[order]
    for i in range(len(probe)):
        matches = sv[sb == probe[i]]
        assert count[i] == len(matches), i
        if len(matches):
            assert fv[i] == matches[0], i


def _expand_oracle(build, bvals, probe):
    """Expected (pidx sequence, per-row value multiset groups)."""
    order = np.lexsort((np.arange(len(probe)), probe))
    pidx, groups = [], []
    for i in order:
        m = np.sort(bvals[build == probe[i]])
        pidx += [i] * len(m)
        groups.append((i, m))
    return np.array(pidx, np.int32), groups


@pytest.mark.slow
@pytest.mark.parametrize("probe_impl", ["auto", "direct", "merge"])
def test_hash_join_expand(probe_impl):
    rng = np.random.RandomState(30)
    build = rng.randint(0, 50, size=300).astype(np.uint32)
    bvals = rng.randint(-1000, 1000, size=300).astype(np.int32)
    probe = rng.randint(0, 60, size=400).astype(np.uint32)
    cap = 8192
    total, pidx, vals = ex.hash_join_expand(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe),
        capacity=cap, probe_impl=probe_impl)
    total = int(total)
    pidx, vals = np.asarray(pidx), np.asarray(vals)
    exp_pidx, groups = _expand_oracle(build, bvals, probe)
    assert total == len(exp_pidx)
    np.testing.assert_array_equal(pidx[:total], exp_pidx)
    assert np.all(pidx[total:] == -1)
    # per-probe value multisets (order within equal build keys is
    # sorter-dependent)
    r = 0
    for i, m in groups:
        np.testing.assert_array_equal(np.sort(vals[r:r + len(m)]), m)
        r += len(m)


def test_hash_join_expand_truncation_and_empty():
    build = np.array([5, 5, 5, 9], np.uint32)
    bvals = np.array([10, 11, 12, 13], np.int32)
    probe = np.array([5, 7, 5], np.uint32)
    total, pidx, vals = ex.hash_join_expand(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe),
        capacity=4)
    assert int(total) == 6          # truncated: 2 probes x 3 matches
    assert np.all(np.asarray(pidx) != -1)
    # no matches at all
    total0, pidx0, _ = ex.hash_join_expand(
        jnp.asarray(build), jnp.asarray(bvals),
        jnp.asarray(np.array([1, 2], np.uint32)), capacity=4)
    assert int(total0) == 0
    assert np.all(np.asarray(pidx0) == -1)


def test_hash_join_expand_xla_fallback():
    rng = np.random.RandomState(31)
    build = rng.randint(0, 40, size=200).astype(np.uint32)
    bvals = rng.randint(0, 9, size=200).astype(np.int32)
    probe = rng.randint(0, 50, size=300).astype(np.uint32)
    total, pidx, vals = ex.hash_join_expand(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe),
        capacity=4096, probe_impl="merge")
    exp_pidx, groups = _expand_oracle(build, bvals, probe)
    assert int(total) == len(exp_pidx)
    np.testing.assert_array_equal(np.asarray(pidx)[:int(total)], exp_pidx)


@pytest.mark.slow
def test_hash_join_expand_sparse_fallback():
    """1-match-per-probe expansion over a 70000-row build."""
    m = 70000
    build = np.arange(m, dtype=np.uint32)
    bvals = (build * 2 + 1).astype(np.int32)
    probe = np.arange(m, dtype=np.uint32)
    total, pidx, vals = ex.hash_join_expand(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe),
        capacity=m, build_sorted=True)
    assert int(total) == m
    pidx, vals = np.asarray(pidx), np.asarray(vals)
    np.testing.assert_array_equal(pidx, np.arange(m))
    np.testing.assert_array_equal(vals, (probe * 2 + 1).astype(np.int32))


def test_hash_join_expand_empty_inputs():
    e32 = np.array([], np.uint32)
    ei = np.array([], np.int32)
    build = np.array([3, 7], np.uint32)
    bvals = np.array([1, 2], np.int32)
    for bk, bv, pk in [(build, bvals, e32), (e32, ei, build)]:
        total, pidx, vals = ex.hash_join_expand(
            jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), capacity=8)
        assert int(total) == 0
        assert np.all(np.asarray(pidx) == -1)
    with pytest.raises(ValueError):
        ex.hash_join_expand(jnp.asarray(build), jnp.asarray(bvals),
                            jnp.asarray(build), capacity=0)


def test_search_build_multi_value_columns():
    """Several value columns gather at the same bounds (vp AND vn)."""
    from cl_ops_tpu.ops.exec.probe import search_build
    rng = np.random.RandomState(33)
    build = np.sort(rng.randint(0, 1 << 20, size=500).astype(np.int32))
    nb = len(build)
    v1 = (np.arange(nb) * 3 + 1).astype(np.int32)
    v2 = (np.arange(nb) * 7 + 2).astype(np.uint64)
    probe = np.sort(rng.randint(0, 1 << 20, size=2000).astype(np.int32))
    count, eq, vps, vns = search_build(
        (jnp.asarray(build),), (jnp.asarray(v1), jnp.asarray(v2)),
        (jnp.asarray(probe),))
    count = np.asarray(count)
    exp = np.searchsorted(build, probe, side="right")
    np.testing.assert_array_equal(count, exp)
    for vals, vp, vn in [(v1, vps[0], vns[0]), (v2, vps[1], vns[1])]:
        np.testing.assert_array_equal(np.asarray(vp),
                                      vals[np.maximum(exp - 1, 0)])
        live = exp < nb
        np.testing.assert_array_equal(np.asarray(vn)[live], vals[exp[live]])


def test_hash_join_u64_keys_sorted_output():
    """Two-limb keys through the sorted-probe form (probe sort + search)."""
    rng = np.random.RandomState(35)
    dim = np.unique((rng.randint(0, 1 << 30, size=200).astype(np.uint64)
                     << np.uint64(33)) | np.uint64(7))
    dim[0] = np.uint64(2**64 - 1)
    dim = np.unique(dim)
    dv = np.arange(len(dim), dtype=np.int32)
    probe = np.concatenate([dim[rng.randint(0, len(dim), size=400)],
                            rng.randint(0, 1000, size=80).astype(np.uint64)])
    rng.shuffle(probe)
    found, vals, rows = ex.hash_join(jnp.asarray(dim), jnp.asarray(dv),
                                     jnp.asarray(probe), sorted_output=True)
    found, vals, rows = np.asarray(found), np.asarray(vals), np.asarray(rows)
    assert np.all(np.diff(probe[rows].astype(np.float64)) >= 0)
    expect = np.isin(probe[rows], dim)
    np.testing.assert_array_equal(found, expect)
    sdim = np.sort(dim)
    lut = {int(k): i for i, k in enumerate(sdim)}
    for i in np.nonzero(expect)[0]:
        assert vals[i] == lut[int(probe[rows[i]])]


def test_hash_join_expand_u64_keys():
    rng = np.random.RandomState(36)
    build = ((rng.randint(0, 8, size=120).astype(np.uint64) << np.uint64(40))
             | rng.randint(0, 4, size=120).astype(np.uint64))
    bvals = rng.randint(0, 99, size=120).astype(np.int32)
    probe = ((rng.randint(0, 10, size=150).astype(np.uint64) << np.uint64(40))
             | rng.randint(0, 4, size=150).astype(np.uint64))
    total, pidx, vals = ex.hash_join_expand(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe),
        capacity=8192)
    exp_pidx, groups = _expand_oracle(build, bvals, probe)
    assert int(total) == len(exp_pidx)
    np.testing.assert_array_equal(np.asarray(pidx)[:int(total)], exp_pidx)
    vals = np.asarray(vals)
    r = 0
    for i, mm in groups:
        np.testing.assert_array_equal(np.sort(vals[r:r + len(mm)]), mm)
        r += len(mm)


def test_group_aggregate_sorted_empty():
    e = jnp.asarray(np.array([], np.uint32))
    ev = jnp.asarray(np.array([], np.int32))
    for agg in ("sum", "count", "min", "max", "mean"):
        gk, table, cnt = ex.group_aggregate_sorted(e, ev, num_groups=4,
                                                   agg=agg)
        assert int(cnt) == 0
        assert table.shape == (4,)
        # dtype matches the non-empty path's
        k1 = jnp.asarray(np.array([1], np.uint32))
        v1 = jnp.asarray(np.array([2], np.int32))
        _, t1, _ = ex.group_aggregate_sorted(k1, v1, num_groups=4, agg=agg)
        assert table.dtype == t1.dtype, agg


def test_hash_join_expand_dup_probes():
    """Duplicate probe keys over runs of 1- and 2-row build keys: each
    repeated probe restarts at its key's first build row, so the build
    positions of the output rows are not monotone."""
    runs = np.array([1] * 20480 + [2] + [2] * 6142 + [1] + [2]
                    + [2] * 4095 + [1] + [1] * (65536 - 40960))
    bk = np.repeat(np.arange(len(runs), dtype=np.int32), runs)
    nb = len(bk)
    assert nb == 65536
    bv = np.arange(nb, dtype=np.int32) + 100
    pk = np.concatenate([
        np.full(2049, bk[20480], np.int32),   # one key probed 2049 times
        bk[20482:32766:2],                    # 6142 pair keys
        [bk[32766]],                          # single-row key
        [bk[32767]], [bk[32767]],             # a 2-row key, twice
        np.repeat(bk[32769:40959:2], 2),      # tail pairs probed twice
        [bk[40959]],
    ]).astype(np.int32)
    capacity = 32768
    total, pidx, vals = ex.hash_join_expand(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
        capacity=capacity, build_sorted=True)
    total = int(total)
    order = np.argsort(pk, kind="stable")
    exp_vals, exp_pidx = [], []
    for p in order:
        lo = np.searchsorted(bk, pk[p], side="left")
        hi = np.searchsorted(bk, pk[p], side="right")
        exp_vals.extend(bv[lo:hi])
        exp_pidx.extend([p] * (hi - lo))
    assert total == len(exp_vals) == capacity
    np.testing.assert_array_equal(np.asarray(vals)[:total], exp_vals)
    np.testing.assert_array_equal(np.asarray(pidx)[:total], exp_pidx)


@pytest.mark.parametrize("unique_build,log2_nb",
                         [(True, 15), (False, 15), (True, 11), (False, 11)])
def test_hash_join_sorted_output(unique_build, log2_nb):
    """sorted_output skips the restore sorts: scattering the outputs back
    through probe_rows must reproduce the default-path results, on both
    the direct and merge strategies, with a build larger and smaller than
    the probe side."""
    rng = np.random.RandomState(60)
    nb = 1 << log2_nb
    if unique_build:
        bk = np.arange(nb, dtype=np.uint32) * 3
    else:
        bk = np.sort(rng.randint(0, nb, size=nb).astype(np.uint32))
    bv = (np.arange(nb, dtype=np.int32) + 7)
    pk = rng.randint(0, 3 * nb, size=1 << 12).astype(np.uint32)
    m = len(pk)
    for impl in ("direct", "merge"):
        ref = ex.hash_join(jnp.asarray(bk), jnp.asarray(bv),
                           jnp.asarray(pk), build_sorted=True,
                           unique_build=unique_build, probe_impl=impl)
        out = ex.hash_join(jnp.asarray(bk), jnp.asarray(bv),
                           jnp.asarray(pk), build_sorted=True,
                           unique_build=unique_build, probe_impl=impl,
                           sorted_output=True)
        f0, v0 = np.asarray(ref[0]), np.asarray(ref[1])
        fs, vs, pr = (np.asarray(out[0]), np.asarray(out[1]),
                      np.asarray(out[2]))
        assert sorted(pr) == list(range(m)), impl
        # the contract: output rows grouped in ascending probe-key order
        assert np.all(np.diff(pk[pr].astype(np.int64)) >= 0), impl
        f1 = np.empty_like(f0)
        v1 = np.empty_like(v0)
        f1[pr] = fs
        v1[pr] = vs
        np.testing.assert_array_equal(f1, f0, err_msg=impl)
        hit = f0 > 0 if unique_build else f0 > 0
        np.testing.assert_array_equal(v1[hit], v0[hit], err_msg=impl)


def test_hash_join_sorted_output_semi_anti_and_small_build():
    """sorted_output keeps the grouped-output contract consumers like
    keys_sorted aggregates rely on, for every join type and a small build
    side."""
    rng = np.random.RandomState(61)
    nb = 1 << 10
    bk = np.arange(nb, dtype=np.uint32) * 2
    bv = np.arange(nb, dtype=np.int32)
    pk = rng.randint(0, 2 * nb, size=4096).astype(np.uint32)
    found, vals, pr = ex.hash_join(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
        build_sorted=True, sorted_output=True)
    pr = np.asarray(pr)
    assert np.all(np.diff(pk[pr].astype(np.int64)) >= 0)  # grouped
    f = np.empty(len(pk), bool)
    f[pr] = np.asarray(found)
    np.testing.assert_array_equal(f, pk % 2 == 0)
    # an unknown strategy is an error
    with pytest.raises(ValueError, match="probe_impl"):
        ex.hash_join(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
                     build_sorted=True, sorted_output=True,
                     probe_impl="banded")
    semi, pr2 = ex.hash_join(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
        build_sorted=True, sorted_output=True, join_type="semi")
    s = np.empty(len(pk), bool)
    s[np.asarray(pr2)] = np.asarray(semi)
    np.testing.assert_array_equal(s, pk % 2 == 0)
    anti, pr3 = ex.hash_join(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
        build_sorted=True, sorted_output=True, join_type="anti")
    a = np.empty(len(pk), bool)
    a[np.asarray(pr3)] = np.asarray(anti)
    np.testing.assert_array_equal(a, pk % 2 == 1)


@pytest.mark.parametrize("unique_build,sorted_output",
                         [(True, False), (True, True), (False, False)])
def test_hash_join_defer_overflow_jit(unique_build, sorted_output):
    """defer_overflow is the serving form: the join under jax.jit appends
    a device overflow flag (always False) and matches the plain call."""
    import jax
    rng = np.random.RandomState(64)
    nb = 1 << 11
    if unique_build:
        bk = np.arange(nb, dtype=np.uint32) * 2
    else:
        bk = np.sort(rng.randint(0, nb, size=nb).astype(np.uint32))
    bv = np.arange(nb, dtype=np.int32) + 3
    pk = rng.randint(0, 2 * nb, size=1 << 13).astype(np.uint32)
    fn = jax.jit(lambda b, v, p: ex.hash_join(
        b, v, p, build_sorted=True, unique_build=unique_build,
        sorted_output=sorted_output, defer_overflow=True))
    out = fn(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk))
    assert not bool(out[-1]), "unexpected overflow flag"
    ref = ex.hash_join(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
                       build_sorted=True, unique_build=unique_build,
                       sorted_output=sorted_output)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for got, want in zip(out[:-1], ref):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_hash_join_defer_overflow_extreme_skew():
    """Probes spread over a build 8x their block span: nothing can
    overflow, so the deferred flag reads False and the results are exact
    on every strategy."""
    nb = 1 << 17
    bk = np.arange(nb, dtype=np.uint32)
    bv = np.arange(nb, dtype=np.int32)
    pk = np.linspace(0, nb - 1, 1 << 14).astype(np.uint32)
    for impl in ("direct", "merge"):
        found, vals, ovf = ex.hash_join(
            jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
            build_sorted=True, probe_impl=impl, defer_overflow=True)
        assert not bool(ovf)
        assert bool(np.asarray(found).all())
        np.testing.assert_array_equal(np.asarray(vals), pk.astype(np.int32))


@pytest.mark.parametrize("unique_build", [True, False])
def test_hash_join_sorted_output_grouped_on_xla_merge(unique_build):
    """The merge strategy must honor the grouped-output contract with a
    REAL probe-row map, not original order + iota (keys_sorted consumers
    would get silently wrong sums)."""
    rng = np.random.RandomState(62)
    nb = 1 << 10
    if unique_build:
        bk = np.arange(nb, dtype=np.uint32) * 2
    else:
        bk = np.sort(rng.randint(0, nb, size=nb).astype(np.uint32))
    bv = np.arange(nb, dtype=np.int32) + 5
    pk = rng.randint(0, 2 * nb, size=4096).astype(np.uint32)
    out = ex.hash_join(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
                       build_sorted=True, unique_build=unique_build,
                       probe_impl="merge", sorted_output=True)
    ref = ex.hash_join(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
                       build_sorted=True, unique_build=unique_build,
                       probe_impl="merge")
    fs, vs, pr = np.asarray(out[0]), np.asarray(out[1]), np.asarray(out[2])
    assert sorted(pr) == list(range(len(pk)))
    assert np.all(np.diff(pk[pr].astype(np.int64)) >= 0)  # grouped
    f0, v0 = np.asarray(ref[0]), np.asarray(ref[1])
    f1 = np.empty_like(f0)
    v1 = np.empty_like(v0)
    f1[pr] = fs
    v1[pr] = vs
    np.testing.assert_array_equal(f1, f0)
    hit = f0 > 0
    np.testing.assert_array_equal(v1[hit], v0[hit])


def test_sorted_output_keys_sorted_composition_small_dim():
    """The userguide's restore-free join->aggregate composition must be
    exact with a small dimension side and the default probe_impl."""
    rng = np.random.RandomState(63)
    nb = 64
    dim_keys = np.arange(nb, dtype=np.uint32) * 2
    dim_vals = np.arange(nb, dtype=np.int32)
    pk = rng.randint(0, 2 * nb, size=4096).astype(np.uint32)
    measure = rng.randint(0, 100, size=4096).astype(np.int32)
    found, _, rows, (m_s, k_s) = ex.hash_join(
        jnp.asarray(dim_keys), jnp.asarray(dim_vals), jnp.asarray(pk),
        build_sorted=True, sorted_output=True,
        probe_cols=(jnp.asarray(measure), jnp.asarray(pk)))
    contrib = jnp.where(found, m_s, jnp.int32(0))
    gk, sums, cnt = ex.group_aggregate_sorted(
        k_s, contrib, num_groups=2 * nb, keys_sorted=True)
    got = {int(k): int(s) for k, s in
           zip(np.asarray(gk)[:int(cnt)], np.asarray(sums)[:int(cnt)])}
    expect = {int(k): int(measure[(pk == k)].sum()) if k % 2 == 0 else 0
              for k in np.unique(pk)}
    assert int(cnt) == len(expect)
    assert got == expect


def test_hash_join_expand_sparse_ranges():
    """Sparse match ranges: every probe matches exactly one build row and
    the matches stride the whole build."""
    nb = 1 << 16
    bk = np.arange(nb, dtype=np.uint32) * 2      # sorted, unique
    bv = np.arange(nb, dtype=np.int32) + 1000
    pk = (np.arange(1 << 14, dtype=np.uint32) * 8)  # = bk[::4]
    for impl in ("direct", "merge"):
        total, pidx, vals = ex.hash_join_expand(
            jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
            capacity=1 << 14, build_sorted=True, probe_impl=impl)
        assert int(total) == len(pk)
        np.testing.assert_array_equal(np.asarray(pidx), np.arange(len(pk)))
        np.testing.assert_array_equal(np.asarray(vals),
                                      (pk // 2 + 1000).astype(np.int32))


def test_filter_compact_wide_columns():
    """Wide (8-byte) and narrow (2-byte) payload columns ride the
    compaction sort as they are."""
    rng = np.random.RandomState(80)
    n = 4096
    x = rng.randint(0, 1000, size=n).astype(np.uint32)
    c64 = rng.randint(0, 1 << 62, size=n, dtype=np.int64).astype(np.uint64)
    f64 = rng.randn(n)
    c16 = rng.randint(0, 1 << 16, size=n).astype(np.uint16)
    pred = lambda d: d < jnp.uint32(300)  # noqa: E731
    count, px, p64, pf, p16 = ex.filter_compact(
        jnp.asarray(x), pred, jnp.asarray(c64), jnp.asarray(f64),
        jnp.asarray(c16))
    k = int(count)
    keep = x < 300
    assert k == keep.sum()
    np.testing.assert_array_equal(np.asarray(px)[:k], x[keep])
    np.testing.assert_array_equal(np.asarray(p64)[:k], c64[keep])
    np.testing.assert_array_equal(np.asarray(pf)[:k], f64[keep])
    np.testing.assert_array_equal(np.asarray(p16)[:k], c16[keep])


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_filter_compact_keeps_input_order(frac):
    """Kept rows come out in input order (the partition is stable), with
    many equal data values and at the all-dropped / all-kept extremes."""
    rng = np.random.RandomState(81)
    n = 3333
    x = rng.randint(0, 4, size=n).astype(np.uint32)
    pos = np.arange(n, dtype=np.int32)
    keep = rng.rand(n) < frac
    flag = jnp.asarray(keep)
    count, pk, pp = ex.filter_compact(
        jnp.asarray(pos), lambda p: jnp.take(flag, p), jnp.asarray(x))
    assert int(count) == keep.sum()
    np.testing.assert_array_equal(np.asarray(pk)[:keep.sum()], pos[keep])
    np.testing.assert_array_equal(np.asarray(pp)[:keep.sum()], x[keep])


def test_hash_join_wide_m_restore():
    """The merge probe's restore without key packing (2m >= 2^31
    regime), exercised by shrinking the pack threshold."""
    from cl_ops_tpu.ops.exec import join as join_mod
    rng = np.random.RandomState(82)
    nb = 1 << 15
    bk = np.arange(nb, dtype=np.uint32) * 3
    bv = np.arange(nb, dtype=np.int32) + 5
    pk = rng.randint(0, 3 * nb, size=4096).astype(np.uint32)
    orig = join_mod._PACK_MAX
    join_mod._PACK_MAX = 64
    try:
        found, vals = ex.hash_join(jnp.asarray(bk), jnp.asarray(bv),
                                   jnp.asarray(pk), build_sorted=True,
                                   probe_impl="merge")
    finally:
        join_mod._PACK_MAX = orig
    expect = pk % 3 == 0
    np.testing.assert_array_equal(np.asarray(found), expect)
    np.testing.assert_array_equal(np.asarray(vals)[expect],
                                  (pk[expect] // 3 + 5).astype(np.int32))


@pytest.mark.parametrize("impl", ["auto", "direct", "merge"])
@pytest.mark.parametrize("unique_build", [True, False])
def test_hash_join_u64_values(impl, unique_build):
    """8-byte build values ride every probe strategy as two i32 limb
    columns (a flattened (n, 2) bitcast would return the LOW limb only)."""
    rng = np.random.RandomState(83)
    nb = (1 << 15) if impl == "auto" else 1000
    if unique_build:
        bk = np.arange(nb, dtype=np.uint32) * 2
    else:
        bk = np.sort(rng.randint(0, nb, size=nb).astype(np.uint32)) * 2
    bv = (np.arange(nb, dtype=np.uint64) + (np.uint64(1) << np.uint64(40)))
    pk = rng.randint(0, 2 * nb, size=2048).astype(np.uint32)
    out = ex.hash_join(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
                       build_sorted=True, probe_impl=impl,
                       unique_build=unique_build)
    found, vals = np.asarray(out[0]), np.asarray(out[1])
    expect = np.isin(pk, bk)
    if unique_build:
        np.testing.assert_array_equal(found, expect)
    else:
        np.testing.assert_array_equal(found > 0, expect)
    lut = {}
    for k, v in zip(bk, bv):
        lut.setdefault(int(k), int(v))  # first match in build order
    for i in np.nonzero(expect)[0]:
        assert int(vals[i]) == lut[int(pk[i])], (impl, i)


def test_hash_join_expand_u64_values():
    rng = np.random.RandomState(84)
    nb = 4096
    bk = np.sort(rng.randint(0, 1024, size=nb).astype(np.uint32))
    bv = rng.randint(0, 1 << 62, size=nb, dtype=np.int64).astype(np.uint64)
    pk = rng.randint(0, 1536, size=512).astype(np.uint32)
    order = np.argsort(pk, kind="stable")
    exp_vals, exp_pidx = [], []
    for p in order:
        lo, hi = np.searchsorted(bk, pk[p]), np.searchsorted(bk, pk[p], "right")
        exp_vals.extend(bv[lo:hi])
        exp_pidx.extend([p] * (hi - lo))
    cap = 1 << int(np.ceil(np.log2(max(len(exp_vals), 2))))
    total, pidx, vals = ex.hash_join_expand(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), capacity=cap,
        build_sorted=True)
    t = int(total)
    assert t == len(exp_vals)
    np.testing.assert_array_equal(np.asarray(pidx)[:t], exp_pidx)
    np.testing.assert_array_equal(np.asarray(vals)[:t], exp_vals)


@pytest.mark.parametrize("agg", ["min", "max"])
@pytest.mark.parametrize("sorter_name", ["xla", "abitonic"])
def test_group_aggregate_sorter_path_minmax(agg, sorter_name):
    """Explicit registry sorter path min/max."""
    from cl_ops_tpu.ops.sort import sort_new
    rng = np.random.RandomState(90)
    keys = rng.randint(0, 37, size=1500).astype(np.uint32)
    vals = rng.randint(-100, 100, size=1500).astype(np.int32)
    s = sort_new(sorter_name)
    gk, table, cnt = ex.group_aggregate_sorted(
        jnp.asarray(keys), jnp.asarray(vals), num_groups=64, agg=agg,
        sorter=s)
    uniq = np.unique(keys)
    assert int(cnt) == len(uniq)
    np.testing.assert_array_equal(np.asarray(gk)[:len(uniq)], uniq)
    oracle = np.min if agg == "min" else np.max
    expect = np.array([oracle(vals[keys == k]) for k in uniq])
    np.testing.assert_array_equal(np.asarray(table)[:len(uniq)], expect)


def test_group_aggregate_keys_sorted_fusion():
    """keys_sorted=True consumes pre-grouped rows without re-sorting —
    the aggregate-after-sorted-join fusion."""
    rng = np.random.RandomState(91)
    keys = np.sort(rng.randint(0, 50, size=2000).astype(np.uint32))
    vals = rng.randint(0, 100, size=2000).astype(np.int32)
    gk, table, cnt = ex.group_aggregate_sorted(
        jnp.asarray(keys), jnp.asarray(vals), num_groups=64, agg="sum",
        keys_sorted=True)
    uniq = np.unique(keys)
    assert int(cnt) == len(uniq)
    np.testing.assert_array_equal(np.asarray(gk)[:len(uniq)], uniq)
    expect = np.array([vals[keys == k].sum() for k in uniq])
    np.testing.assert_array_equal(np.asarray(table)[:len(uniq)], expect)


def test_filter_compact_bool_payload_falls_back():
    """bool payload columns ride the compaction sort as they are."""
    rng = np.random.RandomState(85)
    x = rng.randint(0, 100, size=1024).astype(np.int32)
    flags = (x % 7 == 0)
    pred = lambda d: d < 50  # noqa: E731
    count, px, pf = ex.filter_compact(jnp.asarray(x), pred,
                                      jnp.asarray(flags))
    m = x < 50
    assert int(count) == m.sum()
    np.testing.assert_array_equal(np.asarray(px)[:m.sum()], x[m])
    np.testing.assert_array_equal(np.asarray(pf)[:m.sum()], flags[m])


def test_dist_group_aggregate_minmax_float():
    """Distributed min/max with negative float values."""
    import jax
    from cl_ops_tpu import parallel
    from cl_ops_tpu.parallel.aggregate import dist_group_aggregate
    assert len(jax.devices()) >= 8
    mesh = parallel.make_mesh(8)
    rng = np.random.RandomState(86)
    n = 8 * 128
    keys = rng.randint(0, 13, size=n).astype(np.uint32)
    vals = (rng.randn(n) * 10).astype(np.float32)  # negative floats
    for agg in ("min", "max"):
        gk, table, cnt = dist_group_aggregate(
            jnp.asarray(keys), jnp.asarray(vals), mesh,
            num_groups=32, capacity=n, agg=agg)
        gk = np.asarray(gk).reshape(8, 32)
        table = np.asarray(table).reshape(8, 32)
        cnt = np.asarray(cnt).reshape(8)
        got = {}
        for c in range(8):
            for i in range(cnt[c]):
                got[int(gk[c, i])] = table[c, i]
        oracle = np.min if agg == "min" else np.max
        for k in np.unique(keys):
            np.testing.assert_allclose(got[int(k)], oracle(vals[keys == k]),
                                       rtol=1e-6, err_msg=agg)


@pytest.mark.parametrize("impl", ["direct", "merge"])
def test_hash_join_probe_cols(impl):
    """probe_cols ride the join to output order: the fact-measure channel
    for join -> aggregate (they ride the probe sort on "direct" and are
    gathered through probe_rows on "merge")."""
    rng = np.random.RandomState(92)
    nb = (1 << 11) if impl == "direct" else 512
    bk = np.arange(nb, dtype=np.uint32) * 2
    bv = np.arange(nb, dtype=np.int32)
    pk = rng.randint(0, 2 * nb, size=4096).astype(np.uint32)
    measure = rng.randint(0, 1000, size=4096).astype(np.int32)
    wide = rng.randint(0, 1 << 60, size=4096,
                       dtype=np.int64).astype(np.uint64)
    found, vals, pr, (m_out, w_out) = ex.hash_join(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
        build_sorted=True, probe_impl=impl,
        sorted_output=True, probe_cols=(jnp.asarray(measure),
                                        jnp.asarray(wide)))
    pr = np.asarray(pr)
    np.testing.assert_array_equal(np.asarray(m_out), measure[pr])
    np.testing.assert_array_equal(np.asarray(w_out), wide[pr])
    np.testing.assert_array_equal(np.asarray(found), pk[pr] % 2 == 0)


def test_hash_join_probe_cols_requires_sorted_output():
    bk = np.arange(8, dtype=np.uint32)
    with pytest.raises(ValueError, match="sorted_output"):
        ex.hash_join(jnp.asarray(bk), jnp.asarray(bk.astype(np.int32)),
                     jnp.asarray(bk), build_sorted=True,
                     probe_cols=(jnp.asarray(bk),))


def test_psort_col_encodings_roundtrip():
    """cols_to_i32 / cols_from_i32 round-trip every supported width."""
    from cl_ops_tpu.ops.exec import psort
    rng = np.random.RandomState(93)
    cols = (rng.randint(-100, 100, 256).astype(np.int32),
            rng.randn(256).astype(np.float32),
            rng.randint(0, 1 << 16, 256).astype(np.uint16),
            rng.randint(0, 250, 256).astype(np.uint8),
            rng.randint(0, 1 << 62, 256, dtype=np.int64).astype(np.uint64),
            rng.randn(256))
    jcols = tuple(jnp.asarray(c) for c in cols)
    enc, spec = psort.cols_to_i32(jcols)
    assert all(jnp.dtype(e.dtype) == jnp.int32 for e in enc)
    dec = psort.cols_from_i32(enc, spec)
    for d, c in zip(dec, cols):
        np.testing.assert_array_equal(np.asarray(d), c)


@pytest.mark.parametrize("n,groups,aligned", [(12288, 109, False),
                                              (12288, 96, True),
                                              (4097, 3, False),
                                              (20000, 300, False)])
def test_group_aggregate_sparse_groups_multi_block(n, groups, aligned):
    """Sparse groups (groups * 64 < n) find their ends by the two-level
    search over 4096-row blocks. Its in-block binary search needs
    block.bit_length() halvings: one fewer ended groups one row short
    (37 where 49 was right at 12288 rows and 109 groups). aligned: groups
    of 128 rows after a first one of 130, so a group ends on the second
    row of every 4096-row block — the candidate a short search misses."""
    rng = np.random.RandomState(n + groups)
    if aligned:
        sizes = [130] + [128] * (groups - 2) + [n - 130 - 128 * (groups - 2)]
        keys = rng.permutation(np.repeat(np.arange(groups, dtype=np.int32),
                                         sizes))
    else:
        keys = rng.randint(0, groups, size=n).astype(np.int32)
    vals = rng.randint(0, 100, size=n).astype(np.int32)
    gk, table, cnt = ex.group_aggregate_sorted(
        jnp.asarray(keys), jnp.asarray(vals), num_groups=groups)
    uk = np.unique(keys)
    assert int(cnt) == len(uk)
    np.testing.assert_array_equal(np.asarray(gk)[:len(uk)], uk)
    np.testing.assert_array_equal(
        np.asarray(table)[:len(uk)],
        np.bincount(keys, weights=vals, minlength=groups)[uk].astype(int))


@pytest.mark.parametrize("n", [4096, 4097, 12288, 3 * 4096 + 1])
def test_searchsorted_2level_block_edges(n):
    """The two-level search equals np.searchsorted(side='left') for
    targets at every block's first and last rows."""
    from cl_ops_tpu.ops.exec.aggregate import _searchsorted_2level
    acc = np.arange(1, n + 1, dtype=np.int32)  # strictly increasing
    edges = np.unique(np.concatenate([np.arange(0, n, 4096),
                                      np.arange(4095, n, 4096), [n - 1]]))
    targets = np.concatenate([acc[edges], acc[edges] + 1, [0, n + 5]])
    targets = targets.astype(np.int32)
    got = np.asarray(_searchsorted_2level(jnp.asarray(acc),
                                          jnp.asarray(targets), n))
    np.testing.assert_array_equal(got, np.searchsorted(acc, targets, "left"))
