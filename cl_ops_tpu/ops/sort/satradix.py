"""satradix — LSD radix sort (Satish et al.), reference parity C7.

Mirrors the reference's four-phase pass structure
(`src/cl_ops/sort/clo_sort_satradix.c:264-313`), in plain `jnp`:
  1. per-block digit ranking (ref: satradix_localsort in-workgroup split sort,
     `clo_sort_satradix.cl:34-123`) — each element's stable rank among
     same-digit elements of its block, from a one-hot running count;
  2. per-block digit histogram in column-major `counters[nblocks*digit+blk]`
     layout (ref: satradix_histogram, `clo_sort_satradix.cl:125-222`) — the
     last row of the same running count;
  3. global exclusive scan of the counters via a COMPOSED Scan object —
     the reference composes a CloScan chosen by the `scan=` option
     (`clo_sort_satradix.c:29,296-300,393-406`); the `scan=` option is
     honored here identically (default "xla"; "blelloch" = the Triton
     scan);
  4. scatter to global rank = counters_scan[digit,block] + local rank
     (ref: satradix_scatter, `clo_sort_satradix.cl:224-258`) — an XLA
     unique-index scatter.

Options: `radix=` bins per pass (pow2, default 16 — the reference default,
`clo_sort_satradix.c:353`), `block=` elements per ranking block (pow2,
default 1024), `scan=` composed scan impl, `scanopt...=` passthrough
options (parity `clo_sort_satradix.c:407-421`).

Unlike the reference (pow-2 sizes only, `clo_sort_satradix.cl:41`), any
length works — radix passes are shape-preserving. Total passes = key_bits /
log2(radix) (`clo_sort_satradix.c:167-169`), doubled for 64-bit (two-limb)
keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cl_ops_tpu.ops.sort.abstract import SortImplDef, sort_impls
from cl_ops_tpu.utils.bits import cdiv, is_po2, log2_floor


def _rank_and_hist(digits, radix: int, block: int):
    """(stable rank of each element among its block's same-digit elements,
    (n_blocks, radix) digit histogram)."""
    n = digits.shape[0]
    n_blocks = max(cdiv(n, block), 1)
    # pads take an out-of-range digit, so they never count in a bin
    d2 = jnp.pad(digits, (0, n_blocks * block - n),
                 constant_values=radix).reshape(n_blocks, block)
    onehot = (d2[:, :, None] == jnp.arange(radix, dtype=jnp.int32)
              ).astype(jnp.int32)
    incl = jnp.cumsum(onehot, axis=1, dtype=jnp.int32)
    rank = jnp.take_along_axis(
        incl, jnp.minimum(d2, radix - 1)[:, :, None], axis=2)[:, :, 0] - 1
    return rank.reshape(-1)[:n], incl[:, -1, :]


def _make_satradix_sorter(spec, options):
    radix = int(options.get("radix", 16))
    if not is_po2(radix) or not 2 <= radix <= 256:
        raise ValueError("radix must be a power of 2 in [2, 256]")
    bits = log2_floor(radix)
    block = int(options.get("block", 1024))
    if not is_po2(block):
        raise ValueError("block must be a power of 2")
    scan_name = options.get("scan", "xla")
    scan_opts = {k[4:]: v for k, v in options.items()
                 if k.startswith("scan") and k != "scan"}

    from cl_ops_tpu.ops.scan import scan_new
    scanner = scan_new(scan_name, scan_opts or None, elem_dtype="int",
                       sum_dtype="int")

    def radix_pass(arrs, digits):
        """One stable partition by `digits` (values in [0, radix))."""
        n = digits.shape[0]
        local_rank, hist = _rank_and_hist(digits, radix, block)
        n_blocks = hist.shape[0]
        # counters in column-major digit-major order (parity with
        # counters[num_groups*digit+wg], clo_sort_satradix.cl:158).
        counters = hist.T.reshape(-1)
        base = scanner.scan_with_device_data(counters)
        elem_block = jax.lax.broadcasted_iota(jnp.int32, (n,), 0) // block
        dest = jnp.take(base, digits * n_blocks + elem_block) + local_rank
        return tuple(jnp.zeros_like(a).at[dest].set(
            a, unique_indices=True, mode="promise_in_bounds") for a in arrs)

    def fn(limbs, payload):
        arrs = tuple(limbs) + ((payload,) if payload is not None else ())
        n_limbs = len(limbs)
        # LSD: least-significant limb first (limbs are MSB-first).
        for li in range(n_limbs - 1, -1, -1):
            for shift in range(0, 32, bits):
                u = jax.lax.bitcast_convert_type(
                    arrs[li], jnp.uint32) ^ jnp.uint32(0x80000000)
                digits = ((u >> jnp.uint32(shift))
                          & jnp.uint32(radix - 1)).astype(jnp.int32)
                arrs = radix_pass(arrs, digits)
        out_limbs = arrs[:n_limbs]
        out_payload = arrs[n_limbs] if payload is not None else None
        return out_limbs, out_payload

    return jax.jit(fn)


sort_impls.register("satradix")(lambda: SortImplDef(
    name="satradix",
    in_place=False,  # parity: ref satradix is out-of-place (data_aux buffer)
    make_limb_sorter=_make_satradix_sorter,
    kernel_names=("rank_hist", "counters_scan", "scatter"),
    localmem_usage=lambda k, n, o: 0,
))
