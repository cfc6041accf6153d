"""top_k / distinct tests: differential against numpy sort, including the
threshold fast path, the exact lax.cond fallback on adversarial inputs
(duplicate floods), payload carriage, and jit-ability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cl_ops_tpu.ops.exec import distinct, top_k


def oracle_topk(values, k, payload=None, largest=False):
    order = np.argsort(values, kind="stable")
    if largest:
        # stable descending: sort by (-rank of value, position)
        order = order[::-1]
        # restore stability among equals (argsort reversed breaks it)
        vals = values[order]
        pos = order
        reorder = np.lexsort((pos, -vals.astype(np.int64)))
        order = order[reorder]
    idx = order[:k]
    if payload is None:
        return values[idx]
    return values[idx], payload[idx]


@pytest.mark.parametrize("k", [37, 1000])
@pytest.mark.parametrize("largest", [False, True])
def test_topk_uniform(largest, k):
    rng = np.random.RandomState(0)
    n = 200_000
    vals = rng.randint(0, 1 << 30, size=n).astype(np.uint32)
    payload = np.arange(n, dtype=np.int32)
    got_v, got_p = top_k(vals, k, payload, largest=largest,
                         sample_size=4096)
    ev, ep = oracle_topk(vals, k, payload, largest)
    np.testing.assert_array_equal(np.asarray(got_v), ev)
    np.testing.assert_array_equal(np.asarray(got_p), ep)


@pytest.mark.parametrize("largest", [False, True])
def test_topk_duplicate_flood_exact_fallback(largest):
    """90% of rows equal the minimum: survivors overflow any sane buffer,
    the lax.cond exact branch must fire and still be right."""
    rng = np.random.RandomState(1)
    n, k = 65536, 10
    flood = np.uint32(0xFFFFFFFF) if largest else np.uint32(0)
    vals = np.full(n, flood, np.uint32)
    hi = rng.randint(1, 1 << 20, size=n // 10).astype(np.uint32)
    vals[: n // 10] = hi
    rng.shuffle(vals)
    payload = np.arange(n, dtype=np.int32)
    got_v, got_p = top_k(vals, k, payload, largest=largest,
                         sample_size=1024)
    ev, ep = oracle_topk(vals, k, payload, largest)
    np.testing.assert_array_equal(np.asarray(got_v), ev)
    np.testing.assert_array_equal(np.asarray(got_p), ep)


def test_topk_small_n_full_sort():
    vals = np.array([5, 3, 9, 1, 7], np.int32)
    got = top_k(vals, 3)
    np.testing.assert_array_equal(np.asarray(got[0]), [1, 3, 5])


def test_topk_k_ge_n():
    vals = np.array([5, 3, 9], np.uint32)
    got = top_k(vals, 3)
    np.testing.assert_array_equal(np.asarray(got[0]), [3, 5, 9])


def test_topk_signed_and_float():
    rng = np.random.RandomState(3)
    sv = rng.randint(-(1 << 30), 1 << 30, size=50000).astype(np.int32)
    got = top_k(sv, 5, sample_size=2048)
    np.testing.assert_array_equal(np.asarray(got[0]),
                                  np.sort(sv, kind="stable")[:5])
    fv = rng.randn(50000).astype(np.float32)
    got = top_k(fv, 5, largest=True, sample_size=2048)
    np.testing.assert_array_equal(np.asarray(got[0]),
                                  np.sort(fv)[::-1][:5].astype(np.float32))


def test_topk_wide_dtype_exact_path():
    rng = np.random.RandomState(4)
    vals = rng.randint(0, 1 << 60, size=4096).astype(np.uint64)
    got = top_k(vals, 7)
    np.testing.assert_array_equal(np.asarray(got[0]), np.sort(vals)[:7])


def test_topk_jittable():
    """No host sync: the whole operator traces under jit."""
    vals = jnp.asarray(np.random.RandomState(5)
                       .randint(0, 1 << 30, size=100_000)
                       .astype(np.uint32))
    fn = jax.jit(lambda v: top_k(v, 9, sample_size=2048))
    got = fn(vals)
    np.testing.assert_array_equal(
        np.asarray(got[0]), np.sort(np.asarray(vals))[:9])


def test_topk_bad_k():
    with pytest.raises(ValueError, match="positive"):
        top_k(np.ones(4, np.uint32), 0)


@pytest.mark.parametrize("dtype", [np.uint32, np.int64])
def test_distinct(dtype):
    rng = np.random.RandomState(6)
    keys = rng.randint(-50 if dtype == np.int64 else 0, 100,
                       size=5000).astype(dtype)
    uq, cnt = distinct(keys, capacity=256)
    expect = np.unique(keys)
    assert int(cnt) == len(expect)
    np.testing.assert_array_equal(np.asarray(uq)[: int(cnt)], expect)
