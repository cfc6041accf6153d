"""Scan family tests.

Mirrors the reference's scan verification strategy: differential check against
a serial host scan with a distinct sum dtype (uint elems -> ulong sums,
`src/benchmarks/clo_scan_bench.c:219-271`), parametrized over the impl
registry like the reference's registry-driven loops.
"""

import numpy as np
import pytest

from cl_ops_tpu.ops import scan as scan_mod


def host_exclusive_scan(x, sum_dtype):
    """Serial oracle (parity: clo_scan_bench.c:246-260 check loop)."""
    acc = np.cumsum(x.astype(sum_dtype))
    return np.concatenate([[np.asarray(0, sum_dtype)], acc[:-1]]).astype(
        sum_dtype)


ALL_IMPLS = scan_mod.scan_names()


@pytest.mark.parametrize("impl", ALL_IMPLS)
@pytest.mark.parametrize("n", [1, 7, 128, 1000, 4096, 70000])
def test_exclusive_matches_serial(impl, n):
    rng = np.random.RandomState(42 + n)
    # Values < 128 to delay overflow, like clo_scan_bench.c:219-224.
    x = rng.randint(0, 128, size=n).astype(np.uint32)
    s = scan_mod.scan_new(impl, options="block=256")
    out = s.scan_with_host_data(x)
    expect = host_exclusive_scan(x, np.uint64)
    assert out.dtype == np.uint64
    np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("impl", ALL_IMPLS)
def test_inclusive(impl):
    rng = np.random.RandomState(3)
    x = rng.randint(0, 100, size=1500).astype(np.uint32)
    s = scan_mod.scan_new(impl, options="block=256")
    out = s.scan_with_host_data(x, exclusive=False)
    np.testing.assert_array_equal(out, np.cumsum(x.astype(np.uint64)))


@pytest.mark.parametrize("elem,sum_", [("uchar", "uint"), ("int", "long"),
                                       ("uint", "ulong"), ("float", "float")])
def test_dtype_pairs(elem, sum_):
    """Separate elem/sum types, parity with CLO_SCAN_{ELEM,SUM}_TYPE."""
    rng = np.random.RandomState(7)
    from cl_ops_tpu.core.dtypes import canonicalize
    ed = canonicalize(elem)
    if ed.kind in "ui":
        x = rng.randint(0, 100, size=999).astype(ed)
    else:
        x = rng.rand(999).astype(ed)
    s = scan_mod.scan_new("blelloch", options="block=256",
                          elem_dtype=elem, sum_dtype=sum_)
    out = s.scan_with_host_data(x)
    sd = canonicalize(sum_)
    expect = host_exclusive_scan(x, sd)
    if sd.kind == "f":
        np.testing.assert_allclose(out, expect, rtol=1e-5)
    else:
        np.testing.assert_array_equal(out, expect)


def test_overflow_wraps_like_sum_dtype():
    """Sums exceeding the sum dtype wrap modularly (the reference *detects*
    overflow host-side, clo_scan_bench.c:246-271; device behavior is wrap)."""
    x = np.full(10, 200, np.uint8)
    s = scan_mod.scan_new("blelloch", options="block=256",
                          elem_dtype="uchar", sum_dtype="uchar")
    out = s.scan_with_host_data(x)
    expect = (np.arange(10) * 200 % 256).astype(np.uint8)
    np.testing.assert_array_equal(out, expect)


def test_default_sum_widening():
    s = scan_mod.scan_new("xla", elem_dtype="uint")
    assert s.sum_dtype == np.dtype(np.uint64)
    s2 = scan_mod.scan_new("xla", elem_dtype="half")
    assert s2.sum_dtype == np.dtype(np.float32)


def test_introspection():
    s = scan_mod.scan_new("blelloch")
    assert s.num_kernels == 3
    assert s.kernel_name(2) == "block_scan_base_add"
    # one program holds a 4096-element block of u32 inputs and u64 sums
    assert s.localmem_usage("block_scan_base_add", 1 << 20) == 4096 * 12
    assert s.localmem_usage("block_sums", 1 << 20) == 0
    assert "blelloch" in scan_mod.scan_names()
    assert "xla" in scan_mod.scan_names()


def test_bad_args():
    import pytest as _pt
    from cl_ops_tpu.core.errors import CloOpsError
    with _pt.raises(CloOpsError):
        scan_mod.scan_new("nope")
    s = scan_mod.scan_new("xla")
    with _pt.raises(CloOpsError):
        s.scan_with_device_data(np.zeros((2, 2), np.uint32))
