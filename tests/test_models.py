"""Flagship pipeline tests vs numpy oracles."""

import numpy as np
import pytest

from cl_ops_tpu import models
from cl_ops_tpu.ops.rng import threefry


def _oracle_table(n, seed=0, key_space=1 << 20, value_space=1 << 10):
    ids = np.arange(n, dtype=np.uint32)
    keys = np.asarray(threefry.random_bits(seed, ids, np.uint32(0))) % key_space
    vals = np.asarray(threefry.random_bits(seed, ids, np.uint32(1))) % value_space
    return keys, vals


@pytest.mark.parametrize("impl", ["xla", "abitonic", "satradix"])
def test_sort_pipeline(impl):
    sorted_keys, ok = models.sort_pipeline(4096, seed=1, impl=impl)
    assert bool(ok)
    keys, _ = _oracle_table(4096, 1)
    np.testing.assert_array_equal(np.asarray(sorted_keys), np.sort(keys))


def test_analytics_query():
    n, g, t = 8192, 64, 512
    count, table = models.analytics_query(n, num_groups=g, seed=2,
                                          threshold=t)
    keys, vals = _oracle_table(n, 2)
    m = vals < t
    assert int(count) == m.sum()
    expect = np.zeros(g, np.uint64)
    for k, v in zip(keys[m] % g, vals[m]):
        expect[k] += v
    np.testing.assert_array_equal(np.asarray(table), expect.astype(np.uint32))


@pytest.mark.parametrize("probe_impl", ["direct", "merge"])
def test_star_query(probe_impl):
    n, dim_rows, cats = 1 << 14, 1 << 10, 32
    count, table = models.star_query(n, dim_rows=dim_rows, num_cats=cats,
                                     seed=3, threshold=512,
                                     probe_impl=probe_impl)
    # numpy oracle over the same generated data
    keys, values = (np.asarray(a) for a in models.generate_table(
        n, 3, key_space=dim_rows))
    from cl_ops_tpu.ops.rng import threefry
    dim_cat = np.asarray(
        threefry.random_bits(4, np.arange(dim_rows, dtype=np.uint32),
                             np.uint32(2))) % cats
    keep = values < 512
    assert int(count) == keep.sum()
    exp = np.zeros(cats, np.uint32)
    np.add.at(exp, dim_cat[keys[keep]], values[keep])
    np.testing.assert_array_equal(np.asarray(table), exp)


def test_q1_query():
    """TPC-H-Q1 shape: filter -> six-aggregate multi-measure GROUP BY in
    one jit, against the numpy oracle."""
    import numpy as np
    import jax.numpy as jnp
    from cl_ops_tpu.models.pipeline import q1_query
    from cl_ops_tpu.ops.rng import threefry
    n, g = 1 << 13, 64
    ids = jnp.arange(n, dtype=jnp.uint32)
    keys = np.asarray(threefry.random_bits(0, ids, jnp.uint32(0))
                      % jnp.uint32(g)).astype(np.int64)
    qty = np.asarray(threefry.random_bits(0, ids, jnp.uint32(1))
                     % jnp.uint32(1024)).astype(np.int64)
    price = np.asarray(threefry.random_bits(0, ids, jnp.uint32(2))
                       % jnp.uint32(10000)).astype(np.int64)
    m = qty < 768
    uk = np.unique(keys[m])
    count, gk, (sq, sp, mnq, mxp, c, meanp), gcnt = q1_query(
        n, num_groups=g)
    assert int(count) == m.sum() and int(gcnt) == len(uk)
    np.testing.assert_array_equal(np.asarray(gk)[:len(uk)], uk)
    for i, k in enumerate(uk):
        sel = m & (keys == k)
        assert int(np.asarray(sq)[i]) == qty[sel].sum()
        assert int(np.asarray(sp)[i]) == price[sel].sum()
        assert int(np.asarray(mnq)[i]) == qty[sel].min()
        assert int(np.asarray(mxp)[i]) == price[sel].max()
        assert int(np.asarray(c)[i]) == sel.sum()
        assert abs(float(np.asarray(meanp)[i])
                   - price[sel].mean()) < 1e-2


def test_rollup_query():
    """Restore-free join->aggregate fusion pipeline: ONE probe sort total
    (sorted_output + probe_cols + keys_sorted aggregate); the direct and
    merge probe strategies agree."""
    import numpy as np
    import jax.numpy as jnp
    from cl_ops_tpu.models.pipeline import generate_table, rollup_query
    n, dim_rows = 1 << 13, 1 << 9
    gk, table, cnt = rollup_query(n, dim_rows=dim_rows, probe_impl="direct")
    gk0, t0, c0 = rollup_query(n, dim_rows=dim_rows, probe_impl="merge")
    assert int(cnt) == int(c0)
    k = int(cnt)
    np.testing.assert_array_equal(np.asarray(gk)[:k], np.asarray(gk0)[:k])
    np.testing.assert_array_equal(np.asarray(table)[:k],
                                  np.asarray(t0)[:k])
    # oracle
    keys, measures = generate_table(n, 0, key_space=2 * dim_rows)
    keys, measures = np.asarray(keys), np.asarray(measures).astype(np.int64)
    contrib = np.where(keys % 2 == 0, measures, 0)
    expect = {int(u): int(contrib[keys == u].sum()) for u in np.unique(keys)}
    got = {int(a): int(b) for a, b in
           zip(np.asarray(gk)[:k], np.asarray(table)[:k])}
    assert got == expect
