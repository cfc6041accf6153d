"""Sort family tests.

Mirrors the reference's verification strategy: per-run host sortedness /
equality checks against an oracle (`src/benchmarks/clo_sort_bench.c:216-227`),
parametrized registry-driven over all impls and key dtypes like the
reference's bench CLI type axis.
"""

import numpy as np
import pytest

from cl_ops_tpu.ops import sort as sort_mod
from cl_ops_tpu.ops.sort import keys as keymod

ALL_IMPLS = sort_mod.sort_names()
SMALL_OPTS = {
    "sbitonic": None,
    "abitonic": None,
    "satradix": "block=256",
    "gselect": "chunk=512",
    "xla": None,
}
ALL_DTYPES = ["char", "ushort", "int", "uint", "long", "ulong", "half",
              "float", "double"]


def _rand(dt, n, seed):
    rng = np.random.RandomState(seed)
    dt = np.dtype(dt)
    if dt.kind in "ui" and dt.itemsize == 8:
        # full-range 64-bit draws (top bit set half the time) so the
        # high-limb sign-flip path is really exercised
        lo = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64)
        hi = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64)
        w = lo | (hi << np.uint64(32))
        return w.astype(dt) if dt.kind == "u" else w.view(np.int64)
    if dt.kind == "u":
        return rng.randint(0, 2 ** (8 * dt.itemsize),
                           size=n, dtype=np.uint64).astype(dt)
    if dt.kind == "i":
        lim = 2 ** (8 * dt.itemsize - 1)
        return rng.randint(-lim, lim, size=n,
                           dtype=np.int64).astype(dt)
    return (rng.randn(n) * 100).astype(dt)


@pytest.mark.parametrize("impl", ALL_IMPLS)
@pytest.mark.parametrize("n", [1, 100, 1024, 3000])
def test_sort_u32(impl, n):
    x = _rand(np.uint32, n, 42 + n)
    s = sort_mod.sort_new(impl, SMALL_OPTS[impl])
    out = s.sort_with_host_data(x)
    np.testing.assert_array_equal(out, np.sort(x))


@pytest.mark.parametrize("impl", ["xla", "gselect", "abitonic", "sbitonic",
                                  "satradix"])
@pytest.mark.parametrize("dt", ALL_DTYPES)
def test_sort_all_dtypes(impl, dt):
    from cl_ops_tpu.core.dtypes import canonicalize
    x = _rand(canonicalize(dt), 800, 7)
    s = sort_mod.sort_new(impl, SMALL_OPTS[impl], elem_dtype=dt)
    out = s.sort_with_host_data(x)
    np.testing.assert_array_equal(out, np.sort(x))


@pytest.mark.parametrize("impl", ALL_IMPLS)
def test_sort_descending(impl):
    x = _rand(np.uint32, 640, 3)
    s = sort_mod.sort_new(impl, SMALL_OPTS[impl], ascending=False)
    out = s.sort_with_host_data(x)
    np.testing.assert_array_equal(out, np.sort(x)[::-1])


@pytest.mark.parametrize("impl", ["abitonic", "satradix", "gselect", "xla"])
def test_sort_key_value(impl):
    """KV sort: values follow keys (BASELINE.json satradix KV config)."""
    x = _rand(np.uint32, 600, 5)
    vals = np.arange(600, dtype=np.int32)
    s = sort_mod.sort_new(impl, SMALL_OPTS[impl])
    out, vout = s.sort_with_host_data(x, vals)
    np.testing.assert_array_equal(out, np.sort(x))
    # values must be a permutation consistent with the keys
    np.testing.assert_array_equal(x[vout], out)


@pytest.mark.parametrize("impl", ["satradix", "gselect", "xla"])
def test_sort_stability(impl):
    """Stable impls keep equal-key input order (ref gselect tie-break,
    clo_sort_gselect.cl:51; LSD radix is stable by construction)."""
    x = np.array([3, 1, 3, 1, 2, 2, 1, 3] * 50, np.uint32)
    vals = np.arange(len(x), dtype=np.int32)
    s = sort_mod.sort_new(impl, SMALL_OPTS[impl])
    _, vout = s.sort_with_host_data(x, vals)
    expect = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(vout, expect)


def test_sort_key_fn():
    """Custom key extractor (CLO_SORT_KEY_GET analog): sort by low byte."""
    import jax.numpy as jnp
    x = _rand(np.uint32, 500, 11)
    s = sort_mod.sort_new(
        "xla", key_dtype="uchar",
        key_fn=lambda d: (d & jnp.uint32(0xFF)).astype(jnp.uint8))
    out = s.sort_with_host_data(x)
    assert np.all(np.diff(out & 0xFF) >= 0)
    np.testing.assert_array_equal(np.sort(out), np.sort(x))


@pytest.mark.parametrize("impl", ["sbitonic", "abitonic", "satradix"])
def test_sort_with_duplicates_and_extremes(impl):
    x = np.array([0, 0xFFFFFFFF, 5, 0xFFFFFFFF, 0, 7] * 200, np.uint32)
    s = sort_mod.sort_new(impl, SMALL_OPTS[impl])
    out = s.sort_with_host_data(x)
    np.testing.assert_array_equal(out, np.sort(x))


def test_satradix_radix_option():
    """radix= option parity (clo_sort_satradix.c:353)."""
    x = _rand(np.uint32, 1000, 13)
    for radix in (4, 64, 256):
        s = sort_mod.sort_new("satradix", f"block=256,radix={radix}")
        np.testing.assert_array_equal(s.sort_with_host_data(x), np.sort(x))


def test_satradix_composed_scan():
    """scan= option composes a Scan object (clo_sort_satradix.c:296-300)."""
    x = _rand(np.uint32, 2000, 17)
    s = sort_mod.sort_new("satradix",
                          "block=256,scan=blelloch,scanblock=256")
    np.testing.assert_array_equal(s.sort_with_host_data(x), np.sort(x))


def test_introspection():
    s = sort_mod.sort_new("abitonic")
    assert s.in_place
    assert s.num_kernels == 1
    assert s.kernel_name(0) == "network"
    assert s.localmem_usage("network", 1 << 20) == 0
    r = sort_mod.sort_new("satradix")
    assert not r.in_place
    assert r.num_kernels == 3
    assert set(sort_mod.sort_names()) >= {
        "sbitonic", "abitonic", "gselect", "satradix", "xla"}


def test_bad_args():
    from cl_ops_tpu.core.errors import CloOpsError
    with pytest.raises(CloOpsError):
        sort_mod.sort_new("nope")
    with pytest.raises(CloOpsError):
        sort_mod.sort_new("xla", key_dtype="uchar")  # key_dtype w/o key_fn
    s = sort_mod.sort_new("xla")
    with pytest.raises(CloOpsError):
        s.sort_with_device_data(np.zeros((2, 2), np.uint32))


@pytest.mark.parametrize("impl", ["abitonic", "satradix", "gselect", "xla"])
def test_sort_key_value_duplicates(impl):
    """Duplicate (key, value) PAIRS must not lose rows (the direct value
    payload rides the sort; ranks/exchanges must stay collision-free)."""
    x = np.array([5, 1, 5, 1, 5, 1] * 100, np.uint32)
    vals = np.array([9, 9, 9, 9, 7, 7] * 100, np.int32)
    s = sort_mod.sort_new(impl, SMALL_OPTS[impl])
    out, vout = s.sort_with_host_data(x, vals)
    np.testing.assert_array_equal(out, np.sort(x))
    # multiset of (key, value) pairs preserved
    got = sorted(zip(out.tolist(), vout.tolist()))
    expect = sorted(zip(x.tolist(), vals.tolist()))
    assert got == expect


def test_sort_key_value_float_values():
    x = np.random.RandomState(2).randint(0, 100, size=512).astype(np.uint32)
    vals = np.random.RandomState(3).randn(512).astype(np.float32)
    s = sort_mod.sort_new("abitonic", SMALL_OPTS["abitonic"])
    out, vout = s.sort_with_host_data(x, vals)
    got = sorted(zip(out.tolist(), vout.tolist()))
    expect = sorted(zip(x.tolist(), vals.tolist()))
    assert got == expect


def test_satradix_block_option():
    """block= sets the ranking block; any power of two gives the same
    stable order (keys and the values riding them)."""
    x = _rand(np.uint32, 700, 17)
    v = np.arange(700, dtype=np.int32)
    for block in (64, 1024):
        s = sort_mod.sort_new("satradix", f"block={block},radix=16")
        sk, sv = s.sort_with_host_data(x, v)
        np.testing.assert_array_equal(sk, np.sort(x))
        np.testing.assert_array_equal(sv, np.argsort(x, kind="stable"))
    with pytest.raises(ValueError):
        sort_mod.sort_new("satradix", "block=100")


@pytest.mark.parametrize("impl", ["abitonic", "sbitonic"])
@pytest.mark.parametrize("n", [2, 3, 513, 1024])
def test_bitonic_kv_sizes(impl, n):
    """Pow-2 and padded sizes: the i32-max pad rows never displace a real
    all-max key row, and values stay attached to their keys."""
    x = _rand(np.uint32, n, 21 + n)
    x[::3] = np.uint32(0xFFFFFFFF)
    vals = np.arange(n, dtype=np.int32)
    s = sort_mod.sort_new(impl)
    out, vout = s.sort_with_host_data(x, vals)
    np.testing.assert_array_equal(out, np.sort(x))
    np.testing.assert_array_equal(x[vout], out)
    np.testing.assert_array_equal(np.sort(vout), vals)


def test_bitonic_network_steps():
    """The network over n = 2^k has k(k+1)/2 compare-exchange steps, the
    reference sbitonic's launch count (clo_sort_sbitonic.c:102-118)."""
    from cl_ops_tpu.ops.sort.bitonic import network
    for k in range(1, 11):
        steps = list(network(1 << k))
        assert len(steps) == k * (k + 1) // 2
        assert steps[-1] == (1 << k, 1)
