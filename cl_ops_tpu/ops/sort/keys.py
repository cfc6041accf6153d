"""Order-preserving key normalization to unsigned 32-bit limbs.

The reference specializes sorters over 11 scalar key types via the
`CLO_SORT_KEY_TYPE` / `CLO_SORT_COMPARE` macros
(`src/cl_ops/sort/clo_sort_abstract.c:144-168`), and satradix additionally
requires keys whose *bits* sort correctly (`clo_sort_satradix.cl:34-123`
operates on raw key bits). Here every key dtype is mapped by an
order-preserving bijection onto one or two u32 limbs, so that every sort
and search works on one column type and lexicographic unsigned comparison of
(hi, lo) limbs == the dtype's natural ordering. Radix passes then peel 8-bit
digits off the limbs; bitonic compares limbs directly.

Mappings (standard bit tricks):
  unsigned ints  -> identity (zero-extended)
  signed ints    -> flip sign bit (x ^ 0x80000000 on the high limb)
  floats         -> IEEE trick: if sign bit set, flip ALL bits; else flip
                    just the sign bit. Orders -inf < ... < -0 < +0 < ... <
                    +inf < NaN(+payload); NaNs sort high like totalOrder.
  half           -> widened to float32 first (same ordering).

Limbs are returned most-significant first. Each limb additionally has its
sign bit flipped and is held as int32, so that *signed* i32 comparison of
limbs equals the key order — XLA sorts and the lax networks both compare
naturally, with no unsigned-compare emulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cl_ops_tpu.core.dtypes import canonicalize
from cl_ops_tpu.core.errors import BadDtypeError


def _as_i32(x_u32):
    """u32 (unsigned-ordered) -> i32 whose signed order matches: flip sign."""
    return jax.lax.bitcast_convert_type(x_u32 ^ jnp.uint32(0x80000000),
                                        jnp.int32)


def _from_i32(x_i32):
    """Inverse of _as_i32."""
    return jax.lax.bitcast_convert_type(x_i32, jnp.uint32) ^ jnp.uint32(
        0x80000000)


def _flip_sign_u32(x_u32):
    return x_u32 ^ jnp.uint32(0x80000000)


def _float32_to_ordered_u32(f):
    u = jax.lax.bitcast_convert_type(f, jnp.uint32)
    neg = (u >> jnp.uint32(31)).astype(jnp.bool_)
    return jnp.where(neg, ~u, u ^ jnp.uint32(0x80000000))


def _ordered_u32_to_float32(u):
    neg = jnp.logical_not((u >> jnp.uint32(31)).astype(jnp.bool_))
    raw = jnp.where(neg, ~u, u ^ jnp.uint32(0x80000000))
    return jax.lax.bitcast_convert_type(raw, jnp.float32)


def num_limbs(dtype) -> int:
    """1 for <=32-bit keys, 2 for 64-bit keys."""
    return 2 if canonicalize(dtype).itemsize == 8 else 1


def to_limbs(keys) -> list[jnp.ndarray]:
    """Map keys to order-preserving i32 limbs (most-significant first).

    Signed lexicographic comparison of the limb tuple equals the key
    dtype's natural `<` (ascending), matching the reference's default
    comparator `((a) < (b))` (`clo_sort_abstract.c:151-154`).
    """
    dt = canonicalize(keys.dtype)
    x = jnp.asarray(keys)
    if dt.kind == "u":
        if dt.itemsize == 8:
            lo = (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
            hi = (x >> jnp.uint64(32)).astype(jnp.uint32)
            return [_as_i32(hi), _as_i32(lo)]
        return [_as_i32(x.astype(jnp.uint32))]
    if dt.kind == "i":
        if dt.itemsize == 8:
            u = jax.lax.bitcast_convert_type(x, jnp.uint64)
            lo = (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
            hi = _flip_sign_u32((u >> jnp.uint64(32)).astype(jnp.uint32))
            return [_as_i32(hi), _as_i32(lo)]
        u = jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.uint32)
        return [_as_i32(_flip_sign_u32(u))]
    if dt.kind == "f":
        if dt.itemsize == 8:
            u = jax.lax.bitcast_convert_type(x, jnp.uint64)
            neg = (u >> jnp.uint64(63)).astype(jnp.bool_)
            ordered = jnp.where(neg, ~u, u ^ (jnp.uint64(1) << jnp.uint64(63)))
            lo = (ordered & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
            hi = (ordered >> jnp.uint64(32)).astype(jnp.uint32)
            return [_as_i32(hi), _as_i32(lo)]
        # half/bfloat16 widen to f32 (order-preserving), then the f32 trick.
        return [_as_i32(_float32_to_ordered_u32(x.astype(jnp.float32)))]
    raise BadDtypeError(f"unsupported sort key dtype {dt}")


def from_limbs(limbs: list[jnp.ndarray], dtype) -> jnp.ndarray:
    """Inverse of to_limbs: recover keys from (reordered) limbs."""
    dt = canonicalize(dtype)
    u32 = [_from_i32(l) for l in limbs]
    if dt.kind == "u":
        if dt.itemsize == 8:
            return (u32[0].astype(jnp.uint64) << jnp.uint64(32)
                    | u32[1].astype(jnp.uint64))
        return u32[0].astype(dt)
    if dt.kind == "i":
        if dt.itemsize == 8:
            u = (_flip_sign_u32(u32[0]).astype(jnp.uint64) << jnp.uint64(32)
                 | u32[1].astype(jnp.uint64))
            return jax.lax.bitcast_convert_type(u, jnp.int64)
        raw = jax.lax.bitcast_convert_type(_flip_sign_u32(u32[0]), jnp.int32)
        return raw.astype(dt)
    if dt.kind == "f":
        if dt.itemsize == 8:
            u = (u32[0].astype(jnp.uint64) << jnp.uint64(32)
                 | u32[1].astype(jnp.uint64))
            neg = jnp.logical_not((u >> jnp.uint64(63)).astype(jnp.bool_))
            raw = jnp.where(neg, ~u, u ^ (jnp.uint64(1) << jnp.uint64(63)))
            return jax.lax.bitcast_convert_type(raw, jnp.float64)
        return _ordered_u32_to_float32(u32[0]).astype(dt)
    raise BadDtypeError(f"unsupported sort key dtype {dt}")


def sentinel_max_limbs(n_limbs: int) -> list[int]:
    """Limb values sorting AFTER every real key (for pow-2 padding).

    The reference pads bitonic inputs to nlpo2 with implicit +inf behavior
    (`clo_sort_sbitonic.c:73`); normalized-u32 space makes the all-ones
    pattern the universal max sentinel.
    """
    return [0x7FFFFFFF] * n_limbs  # i32 max == flipped-encoding u32 max
