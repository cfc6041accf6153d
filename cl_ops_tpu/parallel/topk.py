"""Distributed ORDER BY ... LIMIT k and SELECT DISTINCT across the mesh.

Multi-chip siblings of ops/exec/topk.py, built on the classic
select-then-merge reduction: every chip solves its shard exactly with the
single-chip operator, contributes a candidate set bounded by the answer
size, and a final merge over the (tiny) union finishes globally. The
candidate bound is what makes this exact: no chip can place more than
min(k, shard_rows) rows in the global top k, and the global distinct set
is a subset of the union of per-chip distinct sets.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cl_ops_tpu.ops.exec import psort
from cl_ops_tpu.ops.exec.topk import distinct, top_k
from cl_ops_tpu.ops.sort import keys as keymod
from cl_ops_tpu.parallel.mesh import (DATA_AXIS, iota_sharded, mesh_program,
                                      put_sharded, replicated_program)


def dist_top_k(values, k: int, mesh: Mesh, *payload_cols,
               largest: bool = False, axis: str = DATA_AXIS, **topk_kw):
    """The k extreme rows of a row-sharded column, with payload columns.

    Args mirror ops/exec/topk.top_k; `values` and payload columns are
    row-sharded over mesh[axis]. Returns (top_values, *top_payloads) of
    length k, ascending (descending when largest=True), ties broken by
    GLOBAL input position — the same contract as the single-chip operator.
    Pass iota_sharded(n, mesh) as a payload column to receive the winning
    row positions.

    Per chip: one exact local top-min(k, shard) (threshold-select fast
    path with the exact fallback); merge: one lexicographic sort of the
    n_chips * k candidates.
    """
    n = values.shape[0]
    n_chips = mesh.shape[axis]
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if k > n:
        raise ValueError(f"k={k} exceeds row count {n}")
    if n % n_chips:
        raise ValueError(f"length {n} not divisible by {n_chips} chips")
    shard_n = n // n_chips
    kk = min(k, shard_n)

    gpos = iota_sharded(n, mesh, axis)
    enc, spec = psort.cols_to_i32(tuple(payload_cols))

    fn = mesh_program(_local_top_k, mesh, P(axis), P(axis), kk=kk,
                      largest=largest, **topk_kw)
    cand = fn(put_sharded(values, mesh, axis), gpos,
              *(put_sharded(c, mesh, axis) for c in enc))
    # cand: (vals, gpos, *enc payloads), each (n_chips * kk,) global rows.
    # The merge runs replicated so every process of a multi-process mesh
    # can read the k-row result directly.
    merge = replicated_program(_merge_top_k, mesh, k=k, largest=largest,
                               dtype=jnp.dtype(values.dtype), spec=spec)
    return merge(*cand)


def dist_distinct(keys, mesh: Mesh, *, capacity: int,
                  axis: str = DATA_AXIS):
    """SELECT DISTINCT over a row-sharded column.

    Returns (unique_values, count): the first `count` slots hold the
    distinct values ascending, replicated semantics like the single-chip
    operator; later slots are padding. `capacity` bounds the GLOBAL
    distinct count (ops/exec/topk.distinct contract) — per-chip distinct
    counts are automatically within it.

    Per chip: local distinct; padding slots are overwritten with that
    chip's first unique value so they collapse instead of inventing keys;
    merge: one more distinct over the n_chips * capacity candidates.
    """
    n = keys.shape[0]
    n_chips = mesh.shape[axis]
    if n % n_chips:
        raise ValueError(f"length {n} not divisible by {n_chips} chips")
    cap_local = min(capacity, n // n_chips)

    fn = mesh_program(_local_distinct, mesh, P(axis), P(axis),
                      cap_local=cap_local)
    cand = fn(put_sharded(keys, mesh, axis))
    # replicated merge, readable from every process (see dist_top_k)
    return replicated_program(_merge_distinct, mesh, capacity=capacity)(cand)


def _local_top_k(vs, gp, *pls, kk, largest, **topk_kw):
    return tuple(top_k(vs.reshape(-1), kk, gp.reshape(-1),
                       *[p.reshape(-1) for p in pls], largest=largest,
                       **topk_kw))


def _merge_top_k(cvals, cgpos, *cenc, k, largest, dtype, spec):
    """One lexicographic sort of the n_chips * kk candidates."""
    cl = keymod.to_limbs(cvals)
    if largest:
        cl = [jnp.int32(-1) ^ c for c in cl]
    cols = (*cl, cgpos, *cenc)
    merged = tuple(jax.lax.sort(list(cols), num_keys=len(cl) + 1))
    vl = [c[:k] for c in merged[:len(cl)]]
    if largest:
        vl = [jnp.int32(-1) ^ c for c in vl]
    out_vals = keymod.from_limbs(vl, dtype)
    pays = psort.cols_from_i32([c[:k] for c in merged[len(cl) + 1:]], spec)
    return (out_vals, *pays)


def _local_distinct(ks, *, cap_local):
    """One chip's distinct set; padding slots repeat its first value so
    they collapse in the merge instead of inventing keys."""
    uniq, cnt = distinct(ks.reshape(-1), capacity=cap_local)
    idx = jax.lax.broadcasted_iota(jnp.int32, uniq.shape, 0)
    return jnp.where(idx < cnt, uniq, uniq[0])


def _merge_distinct(cand, *, capacity):
    return distinct(cand, capacity=capacity)
