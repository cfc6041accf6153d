"""Distributed window/top-k/distinct tests on the virtual 8-device mesh.

Differential strategy: the single-chip operators are oracle-tested
(tests/test_window.py, tests/test_topk.py), so the distributed versions
check against them on identical inputs — any boundary-carry or candidate-
bound mistake shows up as a row mismatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cl_ops_tpu import parallel
from cl_ops_tpu.ops.exec import window_cols
from cl_ops_tpu.ops.exec.topk import top_k
from cl_ops_tpu.parallel.mesh import iota_sharded


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return parallel.make_mesh(8)


ALL_AGGS = ("sum", "min", "max", "mean", "count", "row_number", "rank",
            "dense_rank", "lag", "lead")


def _case(n, n_keys, seed):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, n_keys, size=n).astype(np.uint32)
    order = rng.randint(0, 40, size=n).astype(np.int32)
    vals = rng.randint(0, 1000, size=n).astype(np.uint32)
    return keys, order, vals


@pytest.mark.parametrize("n,n_keys", [(8 * 125, 6), (8 * 200, 1)])
def test_dist_window_cols_matches_single_chip(mesh8, n, n_keys):
    keys, order, vals = _case(n, n_keys, 3)
    values = tuple(vals if a not in ("count", "row_number", "rank",
                                     "dense_rank") else None
                   for a in ALL_AGGS)
    ref = window_cols(keys, order, values, ALL_AGGS)
    got = parallel.dist_window_cols(keys, order, values, ALL_AGGS, mesh8)
    for a, r, g in zip(ALL_AGGS, ref, got):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-6,
                                    err_msg=f"agg {a}")


def test_dist_window_partition_straddles_chips(mesh8):
    # One giant partition + boundary-aligned partitions: every chip
    # boundary is interior to some partition, exercising the flag fix-up
    # and the segmented-scan carry.
    n = 8 * 64
    keys = np.zeros(n, np.uint32)
    keys[: n // 2] = 7  # one partition spanning chips 0..3
    order = np.arange(n, dtype=np.int32) % 13
    vals = np.arange(n, dtype=np.uint32) % 97
    aggs = ("sum", "row_number", "lag", "lead")
    values = (vals, None, vals, vals)
    ref = window_cols(keys, order, values, aggs)
    got = parallel.dist_window_cols(keys, order, values, aggs, mesh8)
    for a, r, g in zip(aggs, ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=f"agg {a}")


def test_dist_window_exclusive_and_sorted_output(mesh8):
    keys, order, vals = _case(8 * 40, 4, 11)
    ref = window_cols(keys, order, (vals,), ("sum",), exclusive=True)
    got = parallel.dist_window_cols(keys, order, (vals,), ("sum",), mesh8,
                                    exclusive=True)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))

    (sums,), row_src = parallel.dist_window_cols(
        keys, order, (vals,), ("sum",), mesh8, exclusive=True, sorted_output=True)
    restored = np.zeros_like(np.asarray(sums))
    restored[np.asarray(row_src)] = np.asarray(sums)
    np.testing.assert_array_equal(restored, np.asarray(ref[0]))


def test_dist_window_u64_keys(mesh8):
    # two-limb partition keys cross the boundary-correction path
    n = 8 * 32
    rng = np.random.RandomState(5)
    keys = (rng.randint(0, 3, size=n).astype(np.uint64) << np.uint64(40)
            | np.uint64(123))
    vals = rng.randint(0, 100, size=n).astype(np.int32)
    ref = window_cols(keys, None, (vals,), ("sum",))
    got = parallel.dist_window_cols(keys, None, (vals,), ("sum",), mesh8)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))


def test_dist_window_large_shards(mesh8):
    # per-chip shards of 1024 rows
    n = 8 * 1024
    keys, order, vals = _case(n, 5, 17)
    ref = window_cols(keys, order, (vals, None), ("sum", "row_number"))
    got = parallel.dist_window_cols(keys, order, (vals, None),
                                    ("sum", "row_number"), mesh8)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


def test_dist_window_validation(mesh8):
    keys, order, vals = _case(8 * 8, 3, 1)
    with pytest.raises(ValueError):
        parallel.dist_window_cols(keys, order, (vals,), ("bogus",), mesh8)
    with pytest.raises(ValueError):
        parallel.dist_window_cols(keys, None, (None,), ("rank",), mesh8)
    with pytest.raises(ValueError):
        parallel.dist_window_cols(keys, order, (None,), ("sum",), mesh8)


# --- top-k ---------------------------------------------------------------

@pytest.mark.parametrize("largest", [False, True])
def test_dist_top_k_matches_single_chip(mesh8, largest):
    n = 8 * 500
    rng = np.random.RandomState(23)
    vals = rng.randint(0, 300, size=n).astype(np.uint32)  # heavy ties
    pay = rng.randint(-100, 100, size=n).astype(np.int32)
    k = 37
    ref = top_k(vals, k, pay, largest=largest)
    got = parallel.dist_top_k(vals, k, mesh8, pay, largest=largest)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


def test_dist_top_k_k_exceeds_shard(mesh8):
    # k > per-chip rows: every chip contributes its whole sorted shard
    n = 8 * 16
    vals = np.random.RandomState(9).randint(0, 50, size=n).astype(np.uint32)
    k = 40
    got = parallel.dist_top_k(vals, k, mesh8)
    np.testing.assert_array_equal(np.asarray(got[0]), np.sort(vals)[:k])


def test_dist_top_k_positions_payload(mesh8):
    n = 8 * 64
    vals = np.random.RandomState(4).randint(0, 1000, n).astype(np.uint32)
    pos = iota_sharded(n, mesh8)
    got_v, got_p = parallel.dist_top_k(jnp.asarray(vals), 10, mesh8, pos)
    order = np.argsort(vals, kind="stable")[:10]
    np.testing.assert_array_equal(np.asarray(got_p), order)
    np.testing.assert_array_equal(np.asarray(got_v), vals[order])


def test_dist_top_k_validation(mesh8):
    vals = np.arange(16, dtype=np.uint32)
    with pytest.raises(ValueError):
        parallel.dist_top_k(vals, 0, mesh8)
    with pytest.raises(ValueError):
        parallel.dist_top_k(vals, 17, mesh8)


# --- distinct ------------------------------------------------------------

def test_dist_distinct(mesh8):
    n = 8 * 250
    keys = np.random.RandomState(31).randint(0, 97, n).astype(np.uint32)
    uniq, cnt = parallel.dist_distinct(keys, mesh8, capacity=128)
    expect = np.unique(keys)
    assert int(cnt) == len(expect)
    np.testing.assert_array_equal(np.asarray(uniq)[: int(cnt)], expect)


def test_dist_distinct_skewed_one_value(mesh8):
    n = 8 * 32
    keys = np.full(n, 42, np.uint32)
    uniq, cnt = parallel.dist_distinct(keys, mesh8, capacity=16)
    assert int(cnt) == 1 and int(np.asarray(uniq)[0]) == 42
