"""Blelloch prefix sum: three phases, the third a Pallas kernel via Triton.

The reference's Blelloch scan is a GPU workgroup design
(`src/cl_ops/scan/clo_scan_blelloch.cl:49-211`): a scan of each workgroup's
block in local memory, a scan of the workgroup totals, and a uniform add of
those totals back into every block. The same three phases here:

  1. block sums — one XLA reduction over (n_blocks, BLOCK);
  2. the exclusive scan of the n/BLOCK block sums — a tiny XLA cumsum;
  3. one Triton program per block scans its BLOCK elements in registers
     and adds its base: the reference's workgroupScan and addWorkgroupSums
     fused into one pass that reads the input and writes the output once.

So the input is read twice and the output written once. Blocks carry
nothing between them, so the grid runs in any order. Sums accumulate
natively in the sum dtype (64-bit integers included); narrower integers
accumulate in i32 and half floats in f32, then narrow on the store.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from cl_ops_tpu.utils.bits import cdiv, is_po2
from cl_ops_tpu.utils.platform import pallas_mode

BLOCK = 4096       # elements per Triton program (a power of two)
NUM_WARPS = 4


def _acc_dtype(sum_dtype):
    """Dtype the block scan accumulates in for a given output dtype."""
    dt = jnp.dtype(sum_dtype)
    if dt.kind in "iu" and dt.itemsize < 4:
        return jnp.dtype(jnp.int32)
    if dt.kind == "f" and dt.itemsize < 4:
        return jnp.dtype(jnp.float32)
    return dt


def _scan_block_kernel(base_ref, x_ref, out_ref, *, n: int, block: int,
                       exclusive: bool, acc_dtype):
    """Phase 3: scan one block in registers and add its base."""
    pid = pl.program_id(0)
    start = pid * block
    mask = start + jnp.arange(block, dtype=jnp.int32) < n
    x = plgpu.load(x_ref.at[pl.ds(start, block)], mask=mask,
                   other=0).astype(acc_dtype)
    acc = jax.lax.cumsum(x, axis=0) + base_ref[pid]
    if exclusive:
        acc = acc - x
    plgpu.store(out_ref.at[pl.ds(start, block)], acc.astype(out_ref.dtype),
                mask=mask)


def block_bases(x, acc_dtype, block: int):
    """Phases 1-2: each block's exclusive base, in acc_dtype."""
    n = x.shape[0]
    n_blocks = cdiv(n, block)
    xp = jnp.pad(x, (0, n_blocks * block - n)).astype(acc_dtype)
    sums = jnp.sum(xp.reshape(n_blocks, block), axis=1, dtype=acc_dtype)
    return jnp.cumsum(sums, dtype=acc_dtype) - sums


@functools.partial(
    jax.jit,
    static_argnames=("sum_dtype", "exclusive", "block", "num_warps"))
def scan_1d(x, *, sum_dtype, exclusive=True, block=BLOCK,
            num_warps=NUM_WARPS):
    """Prefix sum over a 1-D array of any length.

    Args:
      x: 1-D input.
      sum_dtype: output dtype (the ref's CLO_SCAN_SUM_TYPE,
        `clo_scan_abstract.c:122-125`). Integer sums wrap modulo their
        width, like the reference's OpenCL integer adds.
      exclusive: exclusive (Blelloch) semantics like the reference; False
        gives inclusive.
      block: elements per Triton program, a power of two.
      num_warps: warps per Triton program.
    """
    if not is_po2(block):
        raise ValueError(f"block must be a power of two, got {block}")
    n = x.shape[0]
    # uint64 is uint32 when jax_enable_x64 is off
    sum_dtype = jax.dtypes.canonicalize_dtype(sum_dtype)
    if n == 0:
        return jnp.zeros((0,), sum_dtype)
    acc_dtype = _acc_dtype(sum_dtype)
    mode = pallas_mode()
    logging.getLogger("cl_ops_tpu.scan").debug(
        "scan_1d: n=%d elem=%s sum=%s block=%d mode=%s", n, x.dtype,
        sum_dtype, block, mode)
    base = block_bases(x, acc_dtype, block)
    return pl.pallas_call(
        functools.partial(_scan_block_kernel, n=n, block=block,
                          exclusive=exclusive, acc_dtype=acc_dtype),
        grid=(cdiv(n, block),),
        out_shape=jax.ShapeDtypeStruct((n,), sum_dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=mode == "interpret",
        name="blelloch_block_scan",
    )(base, x)


def scan_least_bytes(n: int, elem_dtype, sum_dtype) -> int:
    """The least bytes any scan of n elements moves: the input read once,
    the output written once (bench/roofline.py's `bytes_moved`). scan_1d
    itself reads the input twice, once for the block sums."""
    return n * (jnp.dtype(elem_dtype).itemsize +
                jnp.dtype(sum_dtype).itemsize)
