"""Multi-chip sort: hypercube bitonic exchange over the mesh.

The chip-level replay of the framework's bitonic network
(`ops/sort/bitonic.py`), which itself re-expresses the reference's bitonic
sorters — the same network over rows inside a chip and over chips inside a
mesh. The reference has
no distributed analog (SURVEY.md §2.3); this realizes the north star's
partition-exchange design with XLA collectives as the backend.

Algorithm (Batcher exchange, standard MPI-bitonic): every shard is kept
locally sorted ascending. For each hypercube stage K and step J, chip `me`
swaps full shards with `me ^ J` via ppermute; the keep-min side takes the
elementwise lexicographic min of (self, reversed partner) — for two
ascending runs this yields the lower half of their union as a bitonic
sequence — then a local bitonic merge restores ascending order. Directions
are static (always ascending); who keeps min follows the bitonic schedule
((me & K) == 0) == ((me & J) == 0). Chip order is fixed by the mesh, so the
result is deterministic (SURVEY.md §7 carry-ordering requirement).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cl_ops_tpu.ops.sort import keys as keymod
from cl_ops_tpu.ops.sort.bitonic import lex_lt
from cl_ops_tpu.parallel.mesh import (DATA_AXIS, iota_sharded, mesh_program,
                                      put_sharded)
from cl_ops_tpu.utils.bits import is_po2, log2_floor, nlpo2


def _sel(mask, a, b):
    return tuple(jnp.where(mask, x, y) for x, y in zip(a, b))


def _local_sort_xla(arrs):
    out = jax.lax.sort(list(arrs), num_keys=len(arrs), is_stable=False)
    return tuple(out)


def _local_merge_xla(arrs):
    """Ascending bitonic merge of a whole (bitonic) local shard via XLA.

    fori_loop with a traced distance keeps the program small (a static
    unroll made XLA CPU compiles of the hypercube dominate test time).
    """
    n = arrs[0].shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    hi = log2_floor(n) - 1

    def body(m, a):
        j = jnp.int32(1) << (jnp.int32(hi) - m)
        p = tuple(jnp.take(x, idx ^ j) for x in a)
        i_low = (idx & j) == 0
        take_self = i_low == lex_lt(a, p)
        return _sel(take_self, a, p)

    return jax.lax.fori_loop(0, hi + 1, body, arrs)


def dist_sort_i32_cols(cols, mesh: Mesh, *, axis: str = DATA_AXIS):
    """Lexicographic global sort of row-sharded i32 columns (hypercube).

    The tuple-level primitive under dist_sort — the distributed sibling of
    psort.sort_i32_cols: EVERY column participates in the comparison in
    order, so put a unique column (e.g. a global position iota) ahead of
    inert payload columns, exactly like the single-chip psort discipline.
    Returns the sorted columns with the same sharding. Lengths must divide
    evenly by the mesh axis; shards pad internally to a power of two (the
    hypercube merge is a bitonic network — XOR-partner gathers on a
    non-po2 shard would silently clamp out of range) with all-lex-max
    sentinel rows that sort to the global tail and are sliced off.
    """
    n_chips = mesh.shape[axis]
    if not is_po2(n_chips):
        raise ValueError(f"mesh axis size {n_chips} must be a power of 2")
    n = cols[0].shape[0]
    if n % n_chips:
        raise ValueError(f"length {n} not divisible by {n_chips} chips")
    shard_n = n // n_chips
    pad = nlpo2(shard_n) - shard_n

    fn = mesh_program(_local_hypercube_sort, mesh, P(axis), P(axis),
                      n_chips=n_chips, pad=pad, axis=axis)
    out = fn(*(put_sharded(a, mesh, axis) for a in cols))
    if pad:
        # Sentinel rows occupy the global tail of the padded sort; slicing
        # the first n rows back to even shards is one resharding jit (the
        # iota_sharded discipline keeps it multi-process safe).
        out = tuple(_unpad_fn(n, mesh, axis)(c) for c in out)
    return out


@functools.lru_cache(maxsize=None)
def _unpad_fn(n: int, mesh: Mesh, axis: str):
    from jax.sharding import NamedSharding
    return jax.jit(lambda c: c[:n],
                   out_shardings=NamedSharding(mesh, P(axis)))


def dist_sort(x, mesh: Mesh, values=None, *, axis: str = DATA_AXIS,
              ascending: bool = True):
    """Sort a row-sharded 1-D array across the mesh.

    Returns the globally sorted array with the same sharding (and reordered
    values if given). Length must divide evenly by the mesh axis size.
    """
    n = x.shape[0]
    limbs = keymod.to_limbs(x)
    if not ascending:
        limbs = [~l for l in limbs]
    n_limbs = len(limbs)
    needs_payload = values is not None or n_limbs > 1
    if needs_payload:
        # iota_sharded, not a host-local iota: multi-process global inputs
        # can only combine with arrays materialized in the same sharding
        payload = iota_sharded(n, mesh, axis)
        arrs = tuple(limbs) + (payload,)
    else:
        arrs = tuple(limbs)

    out = dist_sort_i32_cols(arrs, mesh, axis=axis)

    out_limbs = list(out[:n_limbs])
    if not ascending:
        out_limbs = [~l for l in out_limbs]
    if not needs_payload:
        return keymod.from_limbs(out_limbs, x.dtype)
    perm_idx = out[n_limbs]
    sorted_x = jnp.take(x, perm_idx)
    if values is None:
        return sorted_x
    return sorted_x, jnp.take(values, perm_idx)


def _local_hypercube_sort(*arrs_in, n_chips, pad, axis):
    """One chip's part of the hypercube bitonic sort."""
    arrs_l = tuple(a.reshape(-1) for a in arrs_in)
    if pad:
        mx = jnp.full((pad,), jnp.int32(2 ** 31 - 1))
        arrs_l = tuple(jnp.concatenate([a, mx]) for a in arrs_l)
    me = jax.lax.axis_index(axis)
    arrs_l = _local_sort_xla(arrs_l)
    for sk in range(1, log2_floor(n_chips) + 1):
        k = 1 << sk
        j = k // 2
        while j >= 1:
            perm = [(i, i ^ j) for i in range(n_chips)]
            recv = tuple(jax.lax.ppermute(a, axis, perm) for a in arrs_l)
            rrecv = tuple(jnp.flip(a) for a in recv)
            lt = lex_lt(arrs_l, rrecv)
            mn = _sel(lt, arrs_l, rrecv)
            mx = _sel(lt, rrecv, arrs_l)
            is_lo = (me & j) == 0
            asc_blk = (me & k) == 0
            keep_min = is_lo == asc_blk
            arrs_l = _sel(keep_min, mn, mx)
            arrs_l = _local_merge_xla(arrs_l)
            j //= 2
    return arrs_l
