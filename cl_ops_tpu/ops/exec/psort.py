"""Multi-column i32 sorts for the exec operators, and their column codecs.

The query operators (filter / aggregate / join / window / top-k) compose
sorts the way the reference's satradix composes a scan object
(`src/cl_ops/sort/clo_sort_satradix.c:296-300`). They sort tuples of i32
COLUMNS — normalized key limbs (keys.py) or `flag*n + position` combined
ranks — rather than user-facing dtypes, so they call sort_i32_cols instead
of going through a Sorter object. XLA's GPU sort hands one-operand and
key-value sorts to CUB's radix sort and runs its own tiled sort kernel for
wider tuples.

Comparator convention: rows order by signed-i32 lexicographic comparison of
the key columns, in order. Callers make the leading column(s) unique (e.g.
by mixing in the row position) so the remaining columns are inert payload.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def as_i32(c):
    """Bitcast any 4-byte column to i32 (identity for i32)."""
    if jnp.dtype(c.dtype) == jnp.int32:
        return c
    return jax.lax.bitcast_convert_type(c, jnp.int32)


def from_i32(c, dtype):
    """Inverse of as_i32."""
    if jnp.dtype(dtype) == jnp.int32:
        return c
    return jax.lax.bitcast_convert_type(c, jnp.dtype(dtype))


def flag_pos_key(flag_i32, n: int):
    """`flag * n + position`: one unique i32 key whose ascending sort is a
    STABLE partition — flag-0 rows move to the front in original order.
    Requires 2n < 2^31 (callers gate on this)."""
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    return flag_i32 * jnp.int32(n) + pos


def cols_to_i32(cols):
    """Encode arbitrary-width PAYLOAD columns as i32 columns.

    4-byte columns bitcast 1:1; 8-byte columns split into two i32 limb
    columns; 1/2-byte columns zero-extend. Returns (encoded tuple, spec)
    for cols_from_i32. Payload semantics only — the encoded columns do
    not order like the originals (they ride sorts as inert columns after
    a unique key).
    """
    enc, spec = [], []
    for c in cols:
        dt = jnp.dtype(c.dtype)
        if dt.itemsize == 4:
            enc.append(as_i32(c))
        elif dt.itemsize == 8:
            pair = jax.lax.bitcast_convert_type(c, jnp.int32)  # (n, 2)
            enc.append(pair[:, 0])
            enc.append(pair[:, 1])
        elif dt.itemsize == 2:
            enc.append(jax.lax.bitcast_convert_type(
                c, jnp.uint16).astype(jnp.int32))
        elif dt.itemsize == 1:
            enc.append(jax.lax.bitcast_convert_type(
                c, jnp.uint8).astype(jnp.int32))
        else:
            raise ValueError(f"unsupported payload dtype {dt}")
        spec.append(dt)
    return tuple(enc), tuple(spec)


def cols_from_i32(enc, spec):
    """Inverse of cols_to_i32."""
    out, i = [], 0
    for dt in spec:
        if dt.itemsize == 4:
            out.append(from_i32(enc[i], dt))
            i += 1
        elif dt.itemsize == 8:
            pair = jnp.stack([enc[i], enc[i + 1]], axis=-1)
            out.append(jax.lax.bitcast_convert_type(pair, dt))
            i += 2
        else:
            small = jnp.uint16 if dt.itemsize == 2 else jnp.uint8
            out.append(jax.lax.bitcast_convert_type(
                enc[i].astype(small), dt))
            i += 1
    return tuple(out)


def sort_traffic_bytes(n: int, n_cols: int) -> int:
    """Least bytes a sort of n rows of n_cols i32 columns moves: every
    column read once and written once (the roofline's lower bound)."""
    return 2 * 4 * n * n_cols


def sort_i32_cols(cols, *, num_keys: int | None = None):
    """Sort rows ascending by lexicographic comparison of i32 columns.

    num_keys compares only the first num_keys columns (default: all); the
    rest ride as payload, moved and never compared, so rows stay atomic.
    Rows tied in the key prefix come out in unspecified relative order:
    pass num_keys only when the prefix is unique (it includes a position
    column) or the caller is order-insensitive within ties (aggregation).

    Returns the reordered columns (same dtypes/lengths).
    """
    return tuple(jax.lax.sort(list(cols), num_keys=num_keys or len(cols)))
