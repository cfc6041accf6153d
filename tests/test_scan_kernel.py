"""The Triton block-scan kernel (ops/scan/kernels.py) and its backend route.

On the CPU the kernel runs in the Pallas interpreter; every integer case is
exact against the native oracle's serial scan (`native.exclusive_scan`, the
clo_scan_bench check loop), reduced modulo the sum dtype's width. Sizes
straddle the kernel's block boundaries. The `gpu` cases compile it through
Triton on the card.
"""

import numpy as np
import pytest

from cl_ops_tpu import native
from cl_ops_tpu.ops.scan import kernels

BLOCK = 256
SIZES = [1, BLOCK - 1, BLOCK, BLOCK + 1, 3 * BLOCK + 5]
INT_PAIRS = [(np.uint32, np.uint64), (np.uint32, np.uint32),
             (np.int32, np.int64), (np.int32, np.int32),
             (np.uint64, np.uint64), (np.int64, np.int64),
             (np.uint8, np.uint32), (np.int16, np.int16)]


def _data(dt, n, seed):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _oracle(x, sum_dtype, exclusive=True):
    """Exclusive scan mod 2^64 from the native oracle, narrowed to the sum
    dtype (two's-complement sums wrap alike at every width)."""
    wide = x.astype(np.int64).view(np.uint64)
    out = native.exclusive_scan(wide)
    if not exclusive:
        out = out + wide
    return out.astype(sum_dtype)


def _scan(x, sum_dtype, exclusive=True):
    import jax.numpy as jnp
    return np.asarray(kernels.scan_1d(jnp.asarray(x), sum_dtype=sum_dtype,
                                      exclusive=exclusive, block=BLOCK))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("elem,sum_", INT_PAIRS)
def test_exclusive_exact(elem, sum_, n):
    x = _data(elem, n, n)
    got = _scan(x, sum_)
    assert got.dtype == np.dtype(sum_)
    np.testing.assert_array_equal(got, _oracle(x, sum_))


@pytest.mark.parametrize("elem,sum_", INT_PAIRS)
def test_inclusive_exact(elem, sum_):
    x = _data(elem, 2 * BLOCK + 3, 99)
    np.testing.assert_array_equal(_scan(x, sum_, exclusive=False),
                                  _oracle(x, sum_, exclusive=False))


@pytest.mark.parametrize("elem,sum_", [(np.float32, np.float32),
                                       (np.float16, np.float32)])
def test_float_sums(elem, sum_):
    x = np.random.default_rng(5).random(3 * BLOCK + 5).astype(elem)
    want = np.cumsum(x.astype(np.float64)) - x.astype(np.float64)
    # the kernel adds in another order than the serial sum: f32 rounding
    np.testing.assert_allclose(_scan(x, sum_), want, rtol=1e-5, atol=1e-4)


def test_bad_block():
    import jax.numpy as jnp
    with pytest.raises(ValueError, match="power of two"):
        kernels.scan_1d(jnp.ones(10, jnp.uint32), sum_dtype=jnp.uint32,
                        block=100)


def test_empty():
    import jax.numpy as jnp
    out = kernels.scan_1d(jnp.zeros((0,), jnp.uint32), sum_dtype=jnp.uint64)
    assert out.shape == (0,) and out.dtype == np.uint64


def test_block_bases():
    """Phases 1-2: each block's base is the sum of all earlier blocks."""
    import jax.numpy as jnp
    x = _data(np.uint32, 5 * BLOCK + 7, 3)
    bases = np.asarray(kernels.block_bases(jnp.asarray(x),
                                           jnp.dtype(jnp.uint64), BLOCK))
    starts = np.arange(0, x.size, BLOCK)
    np.testing.assert_array_equal(bases, _oracle(x, np.uint64)[starts])


def test_traffic_model():
    assert kernels.scan_least_bytes(1 << 20, np.uint32, np.uint64) == \
        (1 << 20) * (4 + 8)


@pytest.mark.parametrize("platform,mode", [("cpu", "interpret"),
                                           ("gpu", "triton")])
def test_pallas_mode(monkeypatch, platform, mode):
    import jax
    from cl_ops_tpu.utils import platform as plat
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert plat.pallas_mode() == mode


def test_pallas_mode_refuses_other_platforms(monkeypatch):
    import jax
    from cl_ops_tpu.utils import platform as plat
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no Pallas route"):
        plat.pallas_mode()


def test_compile_cache_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is honoured as set; otherwise the cache is
    `.jax_cache` under the checkout root."""
    import jax
    from cl_ops_tpu.utils import platform as plat
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert plat.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in seen
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = plat.enable_compile_cache()
    assert path == str(plat.checkout_root() / ".jax_cache")
    assert seen["jax_compilation_cache_dir"] == path
    assert (plat.checkout_root() / "cl_ops_tpu").is_dir()


@pytest.mark.gpu
@pytest.mark.parametrize("elem,sum_", [(np.uint32, np.uint64),
                                       (np.uint32, np.uint32),
                                       (np.int64, np.int64)])
def test_triton_compiled_on_gpu(gpu_backend, elem, sum_):
    """Compiled through Triton at a real width, exact against numpy."""
    import jax.numpy as jnp
    from cl_ops_tpu.utils.platform import pallas_mode
    assert pallas_mode() == "triton"
    x = _data(elem, (1 << 22) + 5, 7)
    got = np.asarray(kernels.scan_1d(jnp.asarray(x), sum_dtype=sum_))
    want = np.cumsum(x.astype(sum_), dtype=sum_) - x.astype(sum_)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_operators_on_gpu(gpu_backend):
    """The aggregate's boundary reduce (prefix sums + the two-level end
    search) on the card, exact against numpy."""
    import jax.numpy as jnp
    from cl_ops_tpu.ops.exec import group_aggregate_sorted
    rng = np.random.default_rng(3)
    n, g = 1 << 22, 1 << 14
    keys = rng.integers(0, g, n, dtype=np.int32)
    vals = rng.integers(0, 1000, n, dtype=np.uint32)
    gk, table, cnt = group_aggregate_sorted(jnp.asarray(keys),
                                            jnp.asarray(vals), num_groups=g)
    present = np.flatnonzero(np.bincount(keys, minlength=g))
    c = int(cnt)
    assert c == present.size
    np.testing.assert_array_equal(np.asarray(gk)[:c], present)
    np.testing.assert_array_equal(
        np.asarray(table)[:c],
        np.bincount(keys, weights=vals, minlength=g)[present])


@pytest.mark.gpu
def test_dist_scan_on_gpu(gpu_backend):
    """dist_scan compiled for the card, over every card present."""
    import jax
    from cl_ops_tpu import parallel
    mesh = parallel.make_mesh()
    n = len(jax.devices()) * ((1 << 20) + 3)
    x = _data(np.uint32, n, 11)
    out = parallel.dist_scan(x, mesh, sum_dtype=np.uint64)
    np.testing.assert_array_equal(
        np.asarray(out), np.cumsum(x, dtype=np.uint64) - x.astype(np.uint64))
