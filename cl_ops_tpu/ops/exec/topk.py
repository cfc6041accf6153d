"""ORDER BY ... LIMIT k (top-k) and SELECT DISTINCT.

North-star query operators. No referent in the reference library; they
compose the framework's primitives (psort stable partition, filter
compaction, boundary reduce) the way satradix composes its scan
(`clo_sort_satradix.c:296-300`).

top_k: a full sort moves every row through every pass of the sort, but
LIMIT k with k << n only needs the k extreme rows. So:

  1. estimate a threshold t from a strided sample (the (safety*k/n)-th
     sample quantile) — one tiny sort;
  2. BLOCK-LOCAL EXTRACTION: reshape into 1024-wide blocks and pull up
     to 4 survivors (rows <= t) per block with argmax+clear sweeps — a
     few elementwise passes over the mask, no n-row sort at all (r4
     paid a full stable-partition sort here; r5 verdict item 4's
     economics applied to top-k);
  3. sort only the B*4 extracted candidates by (value, position) — one
     small sort — and gather the k winners' payloads.

The sampled threshold can miss (fewer than k survivors), a block can
hold more than 4 survivors (adversarial clustering/duplicates), or k
can be large enough that extraction could not hold the survivors; a
lax.cond (or a static pre-check, for the k-too-big case) then routes to
the exact full-sort branch, so the result is exact for EVERY input and
the whole operator stays jittable: no host sync, unlike a retry loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cl_ops_tpu.ops.exec import psort
from cl_ops_tpu.ops.sort import keys as keymod


@functools.partial(jax.jit, static_argnames=(
    "k", "largest", "oversample", "sample_size"))
def top_k(values, k: int, *payload_cols, largest: bool = False,
          oversample: int = 4, sample_size: int = 16384):
    """The k extreme rows of `values`, sorted, with payload columns.

    Args:
      values: 1-D column (any normalizable dtype).
      k: static LIMIT.
      *payload_cols: same-length columns returned alongside (SELECT cols).
      largest: False (default) returns the k smallest ascending (ORDER BY
        v LIMIT k); True the k largest descending (ORDER BY v DESC).
      oversample: threshold-quantile safety factor; higher = fewer exact
        fallbacks, more survivors to small-sort.
      sample_size: strided threshold sample length.

    Returns:
      (top_values, *top_payloads), each length k. Exact for every input.
      Ties broken by input position (stable).
    """
    n = values.shape[0]
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    kl = keymod.to_limbs(values)
    if largest:
        kl = [jnp.int32(-1) ^ c for c in kl]  # bitwise NOT reverses order
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    enc, spec = psort.cols_to_i32(tuple(payload_cols))

    def take_k(sorted_limbs_and_rest):
        vl = [c[:k] for c in sorted_limbs_and_rest[:len(kl)]]
        if largest:
            vl = [jnp.int32(-1) ^ c for c in vl]
        out_vals = keymod.from_limbs(vl, values.dtype)
        rest = sorted_limbs_and_rest[len(kl) + 1:]  # skip pos column
        return (out_vals, *psort.cols_from_i32([c[:k] for c in rest], spec))

    if k >= n or len(kl) > 1 or n <= max(4 * k, sample_size):
        # Small n, k ~ n, or multi-limb keys (a one-limb threshold cannot
        # cut multi-limb order exactly): exact full sort. (key, pos) is a
        # unique prefix, so payloads skip the comparator.
        out = psort.sort_i32_cols((*kl, pos, *enc), num_keys=len(kl) + 1)
        return take_k(out)

    limb = kl[0]
    # --- threshold from a strided sample quantile --------------------------
    m = min(sample_size, n)
    stride = n // m
    sample = limb[:: stride][:m]
    ssorted = jax.lax.sort([sample], num_keys=1)[0]
    j = min(m - 1, (m * k * oversample) // n + 1)
    t = ssorted[j]

    # --- block-local survivor extraction (NO n-row sort) -------------------
    # Reshape into W-wide blocks and pull up to _KB survivors per block
    # with argmax+clear sweeps (a few elementwise passes over the mask),
    # then small-sort only the B*_KB candidates. Survivors are Poisson
    # ~oversample*k/B per block, so _KB bounds them with huge margin on
    # non-adversarial data; a block exceeding _KB (or a missed
    # threshold) routes to the exact full-sort fallback, same contract
    # as before — never a wrong answer.
    W, KB = 1024, 4
    if 2 * oversample * k * W >= KB * n:
        # expected survivors per W-block approach the KB budget — the
        # extraction would overflow and fall back anyway; go straight to
        # the exact sort
        out = psort.sort_i32_cols((*kl, pos, *enc), num_keys=len(kl) + 1)
        return take_k(out)
    n2 = ((n + W - 1) // W) * W
    limb2 = jnp.pad(limb, (0, n2 - n),
                    constant_values=0x7FFFFFFF) if n2 != n else limb
    B = n2 // W
    x2 = limb2.reshape(B, W)
    m2 = x2 <= t
    # pad rows only survive when t == i32-max; count > everything then
    # routes to the fallback anyway
    cnt_b = m2.sum(axis=1, dtype=jnp.int32)
    count = jnp.sum(cnt_b)
    blk_ovf = jnp.any(cnt_b > KB)

    blk_base = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0) * W
    idxw = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    mm = m2
    cvals, cposs = [], []
    for _ in range(KB):
        first = jnp.argmax(mm, axis=1).astype(jnp.int32)[:, None]
        has = jnp.take_along_axis(mm, first, axis=1)
        val = jnp.take_along_axis(x2, first, axis=1)
        gpos = blk_base + first
        cvals.append(jnp.where(has, val, jnp.int32(0x7FFFFFFF))[:, 0])
        cposs.append(jnp.where(has & (gpos < n), gpos,
                               jnp.int32(n))[:, 0])
        mm = mm & (idxw != first)
    cval = jnp.concatenate(cvals)
    cpos = jnp.concatenate(cposs)

    ok = (count >= k) & jnp.logical_not(blk_ovf) & (t < 0x7FFFFFFF)

    def fast(_):
        # candidates sorted by (value, pos): ties break by input position,
        # identical to the full sort's order; empties (i32-max, pos=n)
        # sort last and cannot reach slot k while count >= k
        sv, sp = psort.sort_i32_cols((cval, cpos))
        top_pos = jnp.minimum(sp[:k], n - 1)
        vl = [sv[:k]]
        if largest:
            vl = [jnp.int32(-1) ^ c for c in vl]
        out_vals = keymod.from_limbs(vl, values.dtype)
        pays = psort.cols_from_i32([jnp.take(c, top_pos) for c in enc],
                                   spec)
        return (out_vals, *pays)

    def exact(_):
        return take_k(psort.sort_i32_cols((limb, pos, *enc), num_keys=2))

    return jax.lax.cond(ok, fast, exact, None)


@functools.partial(jax.jit, static_argnames=("capacity",))
def distinct(keys_col, *, capacity: int):
    """SELECT DISTINCT: the unique values of a column, ascending.

    Sorts the KEY COLUMN ALONE on normalized limbs, then gathers each
    group's boundary value through the group-by boundary machinery
    (aggregate._boundary_reduce_cols with a free key-ordered gather) —
    no measure column ever rides the sort, so a u32 distinct moves half
    the sort traffic the previous group_aggregate_sorted(count) form
    paid. Returns (unique_values, count): the first `count` slots hold
    the distinct values ascending; later slots are padding. `capacity`
    is the static result-buffer size (distinct count must not exceed
    it).
    """
    from cl_ops_tpu.ops.exec.aggregate import _boundary_reduce_cols
    kl = keymod.to_limbs(keys_col)
    out = psort.sort_i32_cols(tuple(kl))
    skeys = keymod.from_limbs(list(out), keys_col.dtype)
    # "max" over the key itself with key_ordered=True is a pure ends
    # gather — the boundary machinery yields (group_keys, ..., count)
    # with no cumsum over any measure column.
    gk, _, cnt = _boundary_reduce_cols(
        skeys, (skeys,), num_groups=capacity, aggs=("max",),
        key_ordered=(True,))
    return gk, cnt
