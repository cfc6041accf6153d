"""Segmented scan tests: differential check against a serial host oracle.

Same strategy as the plain-scan tests (serial oracle with explicit dtype
semantics, `src/benchmarks/clo_scan_bench.c:246-271`), extended with the
segment dimension: random flag densities, all-flag/no-flag edges, flags
straddling segment runs, and value dtypes.
"""

import numpy as np
import pytest

from cl_ops_tpu.ops.scan import flags_from_segment_ids, segmented_scan_1d


def _identity(op, sum_dtype):
    if op == "add":
        return np.asarray(0, sum_dtype)
    if np.dtype(sum_dtype).kind == "f":
        return np.asarray(np.inf if op == "min" else -np.inf, sum_dtype)
    info = np.iinfo(sum_dtype)
    return np.asarray(info.max if op == "min" else info.min, sum_dtype)


def host_segmented_scan(x, flags, sum_dtype, exclusive, op="add"):
    """Serial oracle with wrapping integer semantics."""
    fn = {"add": lambda a, b: a + b, "min": np.minimum,
          "max": np.maximum}[op]
    out = np.zeros(len(x), dtype=sum_dtype)
    acc = _identity(op, sum_dtype)
    for i in range(len(x)):
        v = np.asarray(x[i], sum_dtype)
        if flags[i]:
            acc = _identity(op, sum_dtype)
        if exclusive:
            out[i] = acc
            acc = fn(acc, v)
        else:
            acc = fn(acc, v)
            out[i] = acc
    return out


def make_case(n, density, seed, dtype=np.uint32, hi=1000):
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind in "iu":
        x = rng.randint(0, hi, size=n).astype(dtype)
    else:
        x = rng.rand(n).astype(dtype)
    flags = (rng.rand(n) < density).astype(np.int32)
    return x, flags


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("n,density", [(1, 0.5), (7, 0.3), (128, 0.1),
                                       (1000, 0.05), (4096, 0.02),
                                       (70000, 0.001)])
def test_matches_serial(n, density, exclusive, dtype):
    x, flags = make_case(n, density, seed=n + int(density * 100),
                         dtype=dtype)
    out = np.asarray(segmented_scan_1d(x, flags, exclusive=exclusive))
    expect = host_segmented_scan(x, flags, dtype, exclusive)
    np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("flag_dtype", [np.int32, np.bool_])
@pytest.mark.parametrize("density", [0.0, 1.0])
def test_degenerate_flags(density, flag_dtype):
    """No flags == plain scan; all flags == exclusive gives zeros."""
    x, flags = make_case(3000, density, seed=9)
    out = np.asarray(segmented_scan_1d(x, flags.astype(flag_dtype),
                                       exclusive=True))
    if density == 0.0:
        expect = (np.cumsum(x, dtype=np.uint32) - x).astype(np.uint32)
    else:
        expect = np.zeros_like(x)
    np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("op", ["add", "max"])
def test_block_boundary_runs(op):
    """Long runs, adjacent flags and a run starting at the last row."""
    n = 8 * 128 * 5
    x = np.ones(n, np.uint32)
    flags = np.zeros(n, np.int32)
    flags[[0, 1500, 1501, 4000, n - 1]] = 1
    out = np.asarray(segmented_scan_1d(x, flags, op=op, exclusive=False))
    expect = host_segmented_scan(x, flags, np.uint32, exclusive=False, op=op)
    np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("dtype,sum_dtype", [
    (np.uint8, np.uint32), (np.int32, np.int32), (np.uint32, np.uint64),
    (np.float32, np.float32), (np.int64, np.int64)])
def test_dtypes(dtype, sum_dtype):
    """Widening, 64-bit XLA fallback, and float paths."""
    x, flags = make_case(5000, 0.02, seed=11, dtype=dtype, hi=100)
    out = np.asarray(segmented_scan_1d(
        x, flags, sum_dtype=sum_dtype, exclusive=True))
    expect = host_segmented_scan(x, flags, sum_dtype, exclusive=True)
    if np.dtype(sum_dtype).kind == "f":
        # Tree-scan association order differs from the serial oracle.
        np.testing.assert_allclose(out, expect, rtol=1e-5)
    else:
        np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("density", [0.03, 0.5])
@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_running_min_max(op, dtype, exclusive, density):
    if np.dtype(dtype).kind in "iu":
        rng = np.random.RandomState(21)
        lo = 0 if np.dtype(dtype).kind == "u" else -(2 ** 30)
        x = rng.randint(lo, 2 ** 30, size=3000).astype(dtype)
        flags = (rng.rand(3000) < density).astype(np.int32)
    else:
        x, flags = make_case(3000, density, seed=21, dtype=dtype)
        x = (x - 0.5).astype(dtype)
    out = np.asarray(segmented_scan_1d(x, flags, op=op,
                                       exclusive=exclusive))
    expect = host_segmented_scan(x, flags, dtype, exclusive, op)
    np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("op", ["min", "max"])
def test_min_max_wide_fallback(op):
    """64-bit accumulators route to the XLA associative_scan path."""
    rng = np.random.RandomState(23)
    x = rng.randint(-(2 ** 60), 2 ** 60, size=2000).astype(np.int64)
    flags = (rng.rand(2000) < 0.05).astype(np.int32)
    out = np.asarray(segmented_scan_1d(x, flags, op=op, exclusive=False))
    expect = host_segmented_scan(x, flags, np.int64, False, op)
    np.testing.assert_array_equal(out, expect)


def test_wrapping_mod32():
    """Per-segment sums that overflow u32 wrap exactly like the oracle."""
    x, flags = make_case(4000, 0.005, seed=13, dtype=np.uint32,
                         hi=2**31 - 1)
    out = np.asarray(segmented_scan_1d(x, flags, exclusive=False))
    expect = host_segmented_scan(x, flags, np.uint32, exclusive=False)
    np.testing.assert_array_equal(out, expect)


def test_flags_from_segment_ids():
    ids = np.array([5, 5, 5, 2, 2, 9, 9, 9, 9, 5], np.int32)
    flags = np.asarray(flags_from_segment_ids(ids))
    np.testing.assert_array_equal(
        flags, [1, 0, 0, 1, 0, 1, 0, 0, 0, 1])
    x = np.ones(len(ids), np.uint32)
    out = np.asarray(segmented_scan_1d(x, flags, exclusive=False))
    np.testing.assert_array_equal(out, [1, 2, 3, 1, 2, 1, 2, 3, 4, 1])


def test_flags_shape_mismatch():
    with pytest.raises(ValueError, match="flags shape"):
        segmented_scan_1d(np.ones(5, np.uint32), np.ones(4, np.int32))
