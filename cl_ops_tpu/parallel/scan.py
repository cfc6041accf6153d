"""Multi-chip prefix sum: chip-local scan + collective carry exchange.

The direct distributed analog of the reference's three-kernel Blelloch
hierarchy (`src/cl_ops/scan/clo_scan_blelloch.cl:49-211`): kernel 1
(per-workgroup scan) becomes the per-chip scan; kernel 2 (scan of workgroup
totals) becomes an `all_gather` of chip totals + masked sum; kernel 3
(uniform add) becomes the local offset add. Chip totals ride the
interconnect; device
order is fixed by the mesh, so carries are deterministic (SURVEY.md §7
"cross-chip scan carry ordering").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cl_ops_tpu.parallel.mesh import DATA_AXIS, mesh_program, put_sharded


def dist_scan(x, mesh: Mesh, *, sum_dtype, exclusive: bool = True,
              axis: str = DATA_AXIS):
    """Exclusive/inclusive prefix sum of a row-sharded 1-D array.

    `x` must be shardable evenly over `mesh[axis]`. Returns an array with the
    same sharding, dtype `sum_dtype`.
    """
    sum_dtype = jnp.dtype(sum_dtype)
    n_shards = mesh.shape[axis]
    if x.shape[0] % n_shards:
        raise ValueError(
            f"array length {x.shape[0]} not divisible by mesh axis "
            f"{axis}={n_shards}")

    fn = mesh_program(_local_scan, mesh, P(axis), P(axis),
                      sum_dtype=sum_dtype, exclusive=exclusive, axis=axis)
    return fn(put_sharded(x, mesh, axis))


def dist_segmented_scan(x, flags, mesh: Mesh, *, sum_dtype=None, op="add",
                        exclusive: bool = True, axis: str = DATA_AXIS):
    """Per-segment running sum/min/max of a row-sharded 1-D array.

    The segmented analog of dist_scan: chip-local segmented scan
    (ops/scan/segmented.py), then an all_gather of each chip's
    (value-since-last-flag, has-flag) pair summary — the pair operator is
    associative, so the carry for chip i combines the tails of the chips
    after the last flagged chip before i. The carry applies only to rows
    before a chip's first flag. Exclusive semantics shift the inclusive
    result through a ppermute of chip-boundary values (no inverse needed,
    so min/max frames work too).

    `flags` marks segment STARTS (nonzero), like segmented_scan_1d; both
    arrays shard evenly over mesh[axis]. Returns the same sharding.
    """
    from cl_ops_tpu.ops.scan.segmented import _OPS
    sum_dtype = jnp.dtype(sum_dtype if sum_dtype is not None else x.dtype)
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; known: {tuple(_OPS)}")
    n_shards = mesh.shape[axis]
    if x.shape[0] % n_shards:
        raise ValueError(
            f"array length {x.shape[0]} not divisible by mesh axis "
            f"{axis}={n_shards}")
    if flags.shape != x.shape:
        raise ValueError(
            f"flags shape {flags.shape} != values shape {x.shape}")

    fn = mesh_program(_local_segmented_scan, mesh, (P(axis), P(axis)),
                      P(axis), n_shards=n_shards, sum_dtype=sum_dtype, op=op,
                      exclusive=exclusive, axis=axis)
    return fn(put_sharded(x.astype(sum_dtype), mesh, axis),
              put_sharded(flags, mesh, axis))


def _local_scan(xs, *, sum_dtype, exclusive, axis):
    """One chip's scan plus the carry of the chips before it."""
    xs = xs.reshape(-1)
    # XLA's cumsum fuses the carry add and the exclusive shift; the Triton
    # block scan, which needs a separate pass for them, ran slower (PERF.md)
    incl = jnp.cumsum(xs.astype(sum_dtype))
    total = incl[-1:]
    # Kernel-2 analog: gather every chip's total, sum those before us.
    totals = jax.lax.all_gather(total, axis).reshape(-1)
    me = jax.lax.axis_index(axis)
    idx = jax.lax.broadcasted_iota(jnp.int32, totals.shape, 0)
    # dtype= pins the accumulator: jnp.sum widens u32 to u64 under x64
    prev = jnp.sum(jnp.where(idx < me, totals, jnp.zeros_like(totals)),
                   dtype=sum_dtype)
    # Kernel-3 analog: uniform add of the carry.
    out = incl + prev
    if exclusive:
        out = out - xs.astype(sum_dtype)
    return out


def _local_segmented_scan(xs, fs, *, n_shards, sum_dtype, op, exclusive,
                          axis):
    """One chip's segmented scan plus the pair-operator carry."""
    from cl_ops_tpu.ops.scan.segmented import (_OPS, _identity_scalar,
                                               segmented_scan_1d)
    combine = _OPS[op]
    xs = xs.reshape(-1)
    fs = (fs.reshape(-1) != 0).astype(jnp.int32)
    incl = segmented_scan_1d(xs, fs, sum_dtype=sum_dtype, op=op,
                             exclusive=False)
    ident = _identity_scalar(op, sum_dtype)
    # Chip summary: value since the chip's last flag (the inclusive
    # scan's tail) + whether the chip has any flag.
    tail = incl[-1:]
    hasflag = (jnp.sum(fs) > 0).astype(jnp.int32).reshape(1)
    tails = jax.lax.all_gather(tail, axis).reshape(-1)
    hflags = jax.lax.all_gather(hasflag, axis).reshape(-1)
    me = jax.lax.axis_index(axis)
    idx = jax.lax.broadcasted_iota(jnp.int32, tails.shape, 0)
    # Last flagged chip before me (0 when none): the carry combines
    # tails[start..me) — tails[start] is already since-last-flag.
    start = jnp.max(jnp.where((idx < me) & (hflags > 0), idx,
                              jnp.zeros_like(idx)))
    live = (idx < me) & (idx >= start)
    masked = jnp.where(live, tails, jnp.full_like(tails, ident))
    if op == "add":
        # dtype= pins the accumulator: jnp.sum otherwise promotes
        # sub-default ints (u32 under x64) and the widened carry would
        # leak into the output dtype, breaking the documented
        # "returns sum_dtype" contract.
        carry = jnp.sum(masked, dtype=sum_dtype)
    elif op == "min":
        carry = jnp.min(masked)
    else:
        carry = jnp.max(masked)
    # Apply only before the chip's first flag.
    noprior = jnp.cumsum(fs) == 0
    out = combine(incl, jnp.where(noprior, carry,
                                  jnp.full_like(incl, ident)))
    if exclusive:
        # Global one-row shift: previous chip's last inclusive value
        # crosses the boundary via ppermute; global row 0 and segment
        # starts take the identity.
        prev_last = jax.lax.ppermute(
            out[-1:], axis,
            perm=[(i, i + 1) for i in range(n_shards - 1)])
        shifted = jnp.concatenate([prev_last, out[:-1]])
        first_row = (jax.lax.broadcasted_iota(jnp.int32, out.shape, 0)
                     == 0) & (me == 0)
        out = jnp.where((fs > 0) | first_row,
                        jnp.full_like(out, ident), shifted)
    return out
