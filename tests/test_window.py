"""Window-function tests: differential check against a pandas-free oracle.

Same differential strategy as the aggregate tests: a serial per-partition
oracle over random keys/orders, both the Pallas (interpret on CPU) and XLA
paths, plus SQL-semantics edges (ties for rank, partition edges for
lag/lead, exclusive frames).
"""

import numpy as np
import pytest

from cl_ops_tpu.ops.exec import window_cols, window_scan


def oracle_windows(keys, order, vals):
    """Per-row running sum/min/max/mean/count, ranks, lag — serial oracle.

    Partitions by key; within a partition rows process in (order, input
    position) order — matching the stable sort the implementation uses.
    """
    n = len(keys)
    idx = sorted(range(n), key=lambda i: (keys[i], order[i], i))
    out = {k: np.zeros(n, np.float64) for k in
           ("sum", "min", "max", "mean", "count", "row_number", "rank",
            "dense_rank", "lag")}
    state = {}
    for i in idx:
        k = keys[i]
        st = state.setdefault(k, {"vals": [], "orders": []})
        st["vals"].append(vals[i])
        st["orders"].append(order[i])
        v = np.asarray(st["vals"])
        out["sum"][i] = v.sum()
        out["min"][i] = v.min()
        out["max"][i] = v.max()
        out["mean"][i] = v.mean()
        out["count"][i] = len(v)
        out["row_number"][i] = len(v)
        ties_before = sum(1 for o in st["orders"][:-1] if o < order[i])
        out["rank"][i] = ties_before + 1
        out["dense_rank"][i] = len(set(st["orders"]))
        out["lag"][i] = st["vals"][-2] if len(st["vals"]) > 1 else 0
    return out


def make_case(n, n_keys, seed):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, n_keys, size=n).astype(np.uint32)
    order = rng.randint(0, 50, size=n).astype(np.int32)  # ties likely
    vals = rng.randint(0, 1000, size=n).astype(np.uint32)
    return keys, order, vals


@pytest.mark.parametrize("n,n_keys", [(300, 7), (3000, 1), (3000, 200),
                                     (5000, 5000)])
def test_window_cols_vs_oracle(n, n_keys):
    keys, order, vals = make_case(n, n_keys, seed=n)
    aggs = ("sum", "min", "max", "mean", "count", "row_number", "rank",
            "dense_rank", "lag")
    vcols = tuple(vals if a not in ("count", "row_number", "rank",
                                    "dense_rank") else None for a in aggs)
    outs = window_cols(keys, order, vcols, aggs)
    expect = oracle_windows(keys, order, vals)
    for a, got in zip(aggs, outs):
        if a == "mean":
            np.testing.assert_allclose(np.asarray(got), expect[a],
                                       rtol=1e-5, err_msg=a)
        else:
            np.testing.assert_array_equal(
                np.asarray(got).astype(np.float64), expect[a], err_msg=a)


@pytest.mark.parametrize("n_keys", [16, 1])
def test_exclusive_frame(n_keys):
    """ROWS UNBOUNDED PRECEDING AND 1 PRECEDING semantics."""
    keys, order, vals = make_case(1200, n_keys, seed=5)
    got = np.asarray(window_scan(keys, vals, order, agg="sum",
                                 exclusive=True))
    incl = np.asarray(window_scan(keys, vals, order, agg="sum",
                                  exclusive=False))
    np.testing.assert_array_equal(got, incl - vals)


def test_unordered_partition_running_sum():
    """order=None: running aggregate follows stable input order."""
    keys = np.array([1, 2, 1, 1, 2], np.uint32)
    vals = np.array([10, 20, 30, 40, 50], np.uint32)
    got = np.asarray(window_scan(keys, vals, agg="sum"))
    np.testing.assert_array_equal(got, [10, 20, 40, 80, 70])


def test_rank_requires_order():
    with pytest.raises(ValueError, match="order column"):
        window_cols(np.ones(4, np.uint32), None, (None,), ("rank",))


def test_lead_partition_edge():
    keys = np.array([1, 1, 1, 2, 2], np.uint32)
    order = np.arange(5, dtype=np.int32)
    vals = np.array([5, 6, 7, 8, 9], np.uint32)
    (lead,) = window_cols(keys, order, (vals,), ("lead",))
    np.testing.assert_array_equal(np.asarray(lead), [6, 7, 0, 9, 0])


@pytest.mark.parametrize("n_keys", [8, 300])
def test_sorted_output_row_src(n_keys):
    keys, order, vals = make_case(1000, n_keys, seed=3)
    (rs,), row_src = window_cols(keys, order, (vals,), ("sum",),
                                 sorted_output=True)
    restored = np.zeros(1000, np.uint32)
    restored[np.asarray(row_src)] = np.asarray(rs)
    full = np.asarray(window_scan(keys, vals, order, agg="sum"))
    np.testing.assert_array_equal(restored, full)
    # outputs really are partition-grouped, order-ascending
    sk = np.asarray(keys)[np.asarray(row_src)]
    assert (np.diff(sk.astype(np.int64)) >= 0).sum() >= \
        (np.unique(sk).size - 1)


def test_wide_measure_xla_path():
    """8-byte measures ride the sort as limb payload and scan via XLA."""
    keys = np.array([1, 1, 2, 2, 1], np.uint32)
    order = np.arange(5, dtype=np.int32)
    vals = (np.arange(5, dtype=np.uint64) + 1) << np.uint64(40)
    got = np.asarray(window_scan(keys, vals, order, agg="sum"))
    expect = np.array([1, 3, 3, 7, 8], np.uint64) << np.uint64(40)
    np.testing.assert_array_equal(got, expect)


def test_mismatched_args():
    with pytest.raises(ValueError, match="equal-length"):
        window_cols(np.ones(4, np.uint32), None, (None,), ("sum", "min"))
    with pytest.raises(ValueError, match="measure column"):
        window_cols(np.ones(4, np.uint32), None, (None,), ("sum",))
    with pytest.raises(ValueError, match="unknown window agg"):
        window_cols(np.ones(4, np.uint32), None, (None,), ("median",))
