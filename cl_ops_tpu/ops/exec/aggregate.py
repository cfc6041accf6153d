"""Hash / group-by aggregation.

North-star operator (BASELINE.json: "GROUP BY over 256M rows, 1M groups").
No referent in the reference library; composes the framework's own
primitives the way satradix composes scan (`clo_sort_satradix.c:296-300`).

Strategies:
  * "direct"  — keys are already dense group ids in [0, num_groups):
    a scatter-add (segment sum) straight into the accumulator table.
  * "sort"    — arbitrary keys: sort rows by key on normalized limbs, then
    detect group boundaries and reduce per group with prefix-sum
    differences and gathers. min/max reduce through a segmented scan, or
    come free as boundary gathers when values ride in the sort key. Group
    results come out in ascending key order — deterministic, unlike
    hash-bucket order.

Aggregations: sum, count, min, max, mean.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cl_ops_tpu.ops.exec import psort
from cl_ops_tpu.ops.sort import keys as keymod

_AGGS = ("sum", "count", "min", "max", "mean")


def _seg_ok(dtype) -> bool:
    """True when min/max reduce through the segmented scan (32-bit-or-
    narrower ints and f32); 64-bit and half-precision values take a
    (group_id, value) sort instead, as _boundary_reduce_cols says."""
    dt = jnp.dtype(dtype)
    return (dt.kind in "iu" and dt.itemsize <= 4) or dt == jnp.float32


def _searchsorted_2level(acc, targets, n: int, block: int = 4096):
    """searchsorted(acc, targets, side="left") for a NONDECREASING acc.

    Level 1 searches the block-decimated tails acc[block-1::block] (a
    ~n/block array that stays in cache, so its gathers are cheap); level 2
    binary-searches inside the one block each target lands in. Same
    result as the flat searchsorted.
    """
    nb = (n + block - 1) // block
    # decimated tails; the last block's tail is acc[n-1]
    tail_idx = jnp.minimum(
        jax.lax.broadcasted_iota(jnp.int32, (nb,), 0) * block + (block - 1),
        n - 1)
    blk_tails = jnp.take(acc, tail_idx)
    blk = jnp.searchsorted(blk_tails, targets,
                           side="left").astype(jnp.int32)
    lo = jnp.minimum(blk * block, n)
    hi = jnp.minimum(lo + block, n)
    # invariant: answer in [lo, hi]; all indices < lo have acc < target.
    # [lo, hi] holds up to block + 1 candidates, so the search needs
    # block.bit_length() halvings.
    steps = block.bit_length()
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = jnp.take(acc, jnp.minimum(mid, n - 1))
        ge = v >= targets
        hi = jnp.where(active & ge, mid, hi)
        lo = jnp.where(active & jnp.logical_not(ge), mid + 1, lo)
    return lo.astype(jnp.int32)


def _csum(x, dtype=None):
    """Inclusive prefix sum in dtype (default x's).

    XLA's own cumsum, not the Triton block scan: XLA fuses the producer
    of x (a flag test, a cast) into its scan, and on the H100 that made
    the 256M-row x 1M-group aggregate 13.1 ms against 15.9 ms through the
    standalone kernel (PERF.md).
    """
    dtype = jnp.dtype(dtype if dtype is not None else x.dtype)
    return jnp.cumsum(x.astype(dtype), dtype=dtype)


def _accumulate(table, group_id, values, agg):
    if agg in ("sum", "mean", "count"):
        return table.at[group_id].add(values, mode="drop")
    if agg == "min":
        return table.at[group_id].min(values, mode="drop")
    if agg == "max":
        return table.at[group_id].max(values, mode="drop")
    raise ValueError(f"unknown agg {agg!r}; known: {_AGGS}")


def _init_scalar(dtype, agg):
    if agg == "min":
        return (jnp.iinfo(dtype).max
                if jnp.issubdtype(dtype, jnp.integer) else jnp.inf)
    if agg == "max":
        return (jnp.iinfo(dtype).min
                if jnp.issubdtype(dtype, jnp.integer) else -jnp.inf)
    return 0


def _init_table(num_groups, dtype, agg):
    return jnp.full((num_groups,), _init_scalar(dtype, agg), dtype)


@functools.partial(jax.jit, static_argnames=("num_groups", "agg"))
def group_aggregate_direct(group_ids, values, *, num_groups: int,
                           agg: str = "sum"):
    """Aggregate values by dense int group id in [0, num_groups).

    Returns the (num_groups,) aggregate table. Out-of-range ids drop.
    """
    if agg == "count":
        values = jnp.ones_like(group_ids, jnp.int32)
    table = _init_table(num_groups, values.dtype, agg)
    table = _accumulate(table, group_ids, values, agg)
    if agg == "mean":
        counts = jnp.zeros((num_groups,), jnp.int32).at[group_ids].add(
            jnp.ones_like(group_ids, jnp.int32), mode="drop")
        return table / jnp.maximum(counts, 1).astype(table.dtype)
    return table


@functools.partial(jax.jit, static_argnames=("num_groups", "agg"))
def _sorted_aggregate(keys, values, *, num_groups: int, agg: str):
    """Sort rows by key with values as PAYLOAD, then boundary-reduce.

    The value column skips the comparator (num_keys); min/max then reduce
    through one segmented scan instead of boundary gathers. Only the
    64-bit/f16 min/max dtypes keep values in the compare prefix
    (vals_in_key_order boundary-gather form).
    """
    kl = keymod.to_limbs(keys)
    vl = keymod.to_limbs(values)
    need_order = agg in ("min", "max") and not _seg_ok(values.dtype)
    nk = len(kl) + (len(vl) if need_order else 0)
    out = psort.sort_i32_cols((*kl, *vl), num_keys=nk)
    skeys = keymod.from_limbs(list(out[:len(kl)]), keys.dtype)
    svals = keymod.from_limbs(list(out[len(kl):]), values.dtype)
    return _boundary_reduce(skeys, svals, num_groups=num_groups, agg=agg,
                            vals_in_key_order=need_order)


@functools.partial(jax.jit, static_argnames=("num_groups", "agg",
                                             "key_bits"))
def group_aggregate_prefix(keys, values, n_valid, *, num_groups: int,
                           agg: str = "sum", key_bits: int | None = None):
    """Aggregate only the first n_valid rows — the filter_compact composer.

    filter_compact returns (count, packed...) with kept rows contiguous at
    the front; this aggregates exactly that prefix without materializing a
    dynamic shape: rows sort by (validity, key, value) so the valid prefix
    is key-sorted and _boundary_reduce's n_valid machinery ignores the
    tail. The canonical filter -> GROUP BY pipeline (BASELINE configs 3+4).
    key_bits: the packing hint of group_aggregate_cols — a caller
    contract that keys are non-negative ints < 2^key_bits (<= 30); the
    validity bit then packs above the key in one sort column.
    """
    n = keys.shape[0]
    kl = keymod.to_limbs(keys)
    vl = keymod.to_limbs(values)
    inv = (jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
           >= n_valid).astype(jnp.int32)
    need_order = agg in ("min", "max") and not _seg_ok(values.dtype)
    if key_bits is not None:
        kd = jnp.dtype(keys.dtype)
        if not (0 < key_bits <= 30):
            raise ValueError("key_bits must be in (0, 30]")
        if kd.kind not in "iu" or kd.itemsize > 4:
            raise ValueError("key_bits packing needs a 4-byte-or-"
                             "narrower integer key column")
        packed = (inv << jnp.int32(key_bits)) | keys.astype(jnp.int32)
        cols = (packed, *vl)
        nk = 1 + (len(vl) if need_order else 0)
        out = psort.sort_i32_cols(cols, num_keys=nk)
        skeys = out[0].astype(keys.dtype)
        svals = keymod.from_limbs(list(out[1:]), values.dtype)
        return _boundary_reduce(skeys, svals, num_groups=num_groups,
                                agg=agg, n_valid=n_valid,
                                vals_in_key_order=need_order)
    cols = (inv, *kl, *vl)
    nk = 1 + len(kl) + (len(vl) if need_order else 0)
    out = psort.sort_i32_cols(cols, num_keys=nk)
    skeys = keymod.from_limbs(list(out[1:1 + len(kl)]), keys.dtype)
    svals = keymod.from_limbs(list(out[1 + len(kl):]), values.dtype)
    return _boundary_reduce(skeys, svals, num_groups=num_groups, agg=agg,
                            n_valid=n_valid, vals_in_key_order=need_order)


def group_aggregate_sorted(keys, values, *, num_groups: int, agg: str = "sum",
                           sorter=None, keys_sorted: bool = False):
    """Aggregate values by arbitrary key: sort -> boundary scan -> reduce.

    By default rows sort by key with values as payload through
    `jax.lax.sort`. Passing an explicit registry `sorter` sorts through it
    instead (the reference-style op-composition path). keys_sorted=True
    skips the input sort entirely — the fusion path for producers that
    already emit key-grouped rows (e.g. hash_join/hash_join_expand with
    sorted_output: an aggregate after a join need not pay the join's
    restore sort NOR its own input sort).

    Returns (group_keys, table, count): the first `count` entries of
    group_keys/table hold one row per distinct key in ascending key order;
    later entries are padding. num_groups is the table capacity
    (distinct-key count must not exceed it).
    """
    if keys.shape[0] == 0:
        if agg == "count":
            table_dt = jnp.dtype(jnp.int32)
        elif agg == "mean":  # same promotion as the divide in the real path
            table_dt = (jnp.zeros((), values.dtype) / jnp.int32(1)).dtype
        else:
            table_dt = values.dtype
        return (jnp.zeros((num_groups,), keys.dtype),
                jnp.zeros((num_groups,), table_dt), jnp.int32(0))
    if keys_sorted:
        return _boundary_reduce(keys, values, num_groups=num_groups,
                                agg=agg)
    if sorter is None:
        return _sorted_aggregate(keys, values, num_groups=num_groups,
                                 agg=agg)
    skeys, svals = sorter.sort_with_device_data(keys, values)
    return _boundary_reduce(skeys, svals, num_groups=num_groups, agg=agg)


def group_aggregate_cols(keys, values, aggs, *, num_groups: int,
                         n_valid=None, valid_mask=None,
                         keys_sorted: bool = False,
                         key_bits: int | None = None):
    """Multi-measure GROUP BY: one input sort, one boundary scan, one
    reduction per (column, agg) — the SELECT sum(a), min(b), count(*)
    shape (e.g. TPC-H Q1), where re-sorting the table per measure would
    multiply the dominant cost.

    values: tuple of measure columns (same length); aggs: matching tuple
    from sum/count/min/max/mean ("count" ignores its column's values).
    Rows sort by key on normalized limbs with the measures as payload;
    min/max columns reduce through one segmented min/max scan each (a
    64-bit/f16 first column instead rides the key order, making its
    min/max free boundary gathers). n_valid aggregates only rows
    < n_valid after partitioning validity to the front (the
    filter_compact composer). valid_mask aggregates only rows where the
    boolean mask holds — the FUSED filter form: validity becomes the
    leading sort column directly, so a WHERE + GROUP BY pipeline pays no
    separate filter_compact partition at all (its row count is returned
    by count_where or jnp.sum of the mask). keys_sorted=True consumes
    pre-grouped rows (e.g. hash_join sorted_output + probe_cols) with no
    input sort at all. key_bits is the WHERE-fusion packing hint: a
    CALLER CONTRACT that keys are non-negative integers < 2^key_bits
    (<= 30); the validity bit then packs ABOVE the key in one i32
    column instead of riding as its own sort column — one fewer column
    of sort traffic on the flagship q1 shape. Like the num_groups
    capacity, the contract is the caller's to honor (engines know
    column bounds from stats); violating it gives undefined results.

    Returns (group_keys, tables, count): tables is a tuple aligned with
    `values`; the first `count` rows of each hold one aggregate per
    distinct key, ascending; later entries are padding.
    """
    if len(values) != len(aggs) or not values:
        raise ValueError("values and aggs must be equal-length, non-empty")
    for a in aggs:
        if a not in _AGGS:
            raise ValueError(f"unknown agg {a!r}")
    if keys_sorted and (n_valid is not None or valid_mask is not None):
        raise ValueError("n_valid/valid_mask require the sorting path "
                         "(keys_sorted=False)")
    if key_bits is not None:
        kd = jnp.dtype(keys.dtype)
        if not (0 < key_bits <= 30):
            raise ValueError("key_bits must be in (0, 30]")
        if kd.kind not in "iu" or kd.itemsize > 4:
            raise ValueError("key_bits packing needs a 4-byte-or-"
                             "narrower integer key column")
        if keys_sorted or (n_valid is None and valid_mask is None):
            key_bits = None  # nothing to pack without a validity bit
    if n_valid is not None and valid_mask is not None:
        raise ValueError("pass n_valid or valid_mask, not both")
    if keys.shape[0] == 0:
        def table_dt(v, a):
            if a == "count":
                return jnp.dtype(jnp.int32)
            if a == "mean":
                return (jnp.zeros((), v.dtype) / jnp.int32(1)).dtype
            return v.dtype
        return (jnp.zeros((num_groups,), keys.dtype),
                tuple(jnp.zeros((num_groups,), table_dt(v, a))
                      for v, a in zip(values, aggs)), jnp.int32(0))
    if keys_sorted:
        return _boundary_reduce_cols(
            keys, tuple(values), num_groups=num_groups, aggs=tuple(aggs),
            key_ordered=(False,) * len(values))
    # Dedup measure columns BY IDENTITY before the jit boundary (inside
    # the jit each tuple slot is a distinct tracer and identity would
    # never hold): several aggs over one measure (Q1's sum+min+count of
    # qty) must sort that column ONCE, not once per agg — the fused sort
    # is the dominant cost and its traffic scales with column count.
    uniq, slot_map, seen = [], [], {}
    for v in values:
        j = seen.get(id(v))
        if j is None:
            j = len(uniq)
            seen[id(v)] = j
            uniq.append(v)
        slot_map.append(j)
    # Measure columns ride the sort as PAYLOAD (num_keys): min/max reduce
    # through segmented scans. Only a first-column min/max of a 64-bit/f16
    # dtype (see _seg_ok) pulls that column into the compare prefix for
    # the key-ordered boundary-gather form.
    first_in_prefix = any(
        a in ("min", "max") and j == 0 and not _seg_ok(uniq[0].dtype)
        for a, j in zip(aggs, slot_map))
    key_ordered = tuple(j == 0 and first_in_prefix for j in slot_map)
    return _group_aggregate_cols_sort(
        keys, tuple(uniq), n_valid, valid_mask, num_groups=num_groups,
        aggs=tuple(aggs), key_ordered=key_ordered,
        slot_map=tuple(slot_map), first_in_prefix=first_in_prefix,
        key_bits=key_bits)


@functools.partial(jax.jit, static_argnames=("num_groups", "aggs",
                                             "key_ordered", "slot_map",
                                             "first_in_prefix", "key_bits"))
def _group_aggregate_cols_sort(keys, values, n_valid, valid_mask, *,
                               num_groups: int, aggs, key_ordered,
                               slot_map=None, first_in_prefix: bool = False,
                               key_bits: int | None = None):
    # values holds the UNIQUE measure columns; slot_map (static) maps each
    # agg slot to its unique column, so the fused sort moves each column
    # once no matter how many aggs read it.
    if slot_map is None:
        slot_map = tuple(range(len(values)))
    kl = keymod.to_limbs(keys)
    vls = [keymod.to_limbs(v) for v in values]
    n = keys.shape[0]
    if valid_mask is not None:
        # fused filter: the mask IS the leading sort column; valid rows
        # land in a prefix of length sum(mask), same as n_valid below
        inv = jnp.int32(1) - valid_mask.astype(jnp.int32)
        n_valid = jnp.sum(valid_mask.astype(jnp.int32))
        skip = 1
    elif n_valid is not None:
        inv = (jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
               >= n_valid).astype(jnp.int32)
        skip = 1
    else:
        inv = None
        skip = 0
    if key_bits is not None and inv is not None:
        # WHERE-fusion packing (caller contract: 0 <= key < 2^key_bits):
        # the validity bit rides ABOVE the key in ONE i32 column — a
        # non-negative i32 orders identically to (inv, key), and for the
        # valid prefix (inv = 0) the packed value IS the key, so the
        # boundary reduce consumes it directly. One fewer column of
        # sort traffic than the separate-inv form below.
        packed = ((inv << jnp.int32(key_bits))
                  | keys.astype(jnp.int32))
        cols = (packed, *(c for vl in vls for c in vl))
        nk = 1 + (len(vls[0]) if first_in_prefix else 0)
        out = psort.sort_i32_cols(cols, num_keys=nk)
        skeys = out[0].astype(keys.dtype)
        skip, kl = 1, ()  # measure columns start at out[1]
    else:
        cols = ((inv, *kl) if inv is not None else (*kl,)) \
            + tuple(c for vl in vls for c in vl)
        nk = skip + len(kl) + (len(vls[0]) if first_in_prefix else 0)
        out = psort.sort_i32_cols(cols, num_keys=nk)
        skeys = keymod.from_limbs(list(out[skip:skip + len(kl)]),
                                  keys.dtype)
    suniq = []
    off = skip + len(kl)
    for v, vl in zip(values, vls):
        suniq.append(keymod.from_limbs(list(out[off:off + len(vl)]),
                                       v.dtype))
        off += len(vl)
    svals = tuple(suniq[j] for j in slot_map)  # re-expand to agg slots
    return _boundary_reduce_cols(
        skeys, svals, num_groups=num_groups, aggs=aggs,
        key_ordered=key_ordered, n_valid=n_valid)


def _boundary_reduce(skeys, svals, *, num_groups: int, agg: str,
                     n_valid=None, vals_in_key_order: bool = False):
    """Scatter-free segmented reduce over key-sorted rows (one measure).

    Thin wrapper over _boundary_reduce_cols — see it for the mechanism
    and the n_valid contract."""
    gk, tables, count = _boundary_reduce_cols(
        skeys, (svals,), num_groups=num_groups, aggs=(agg,),
        key_ordered=(vals_in_key_order,), n_valid=n_valid)
    return gk, tables[0], count


@functools.partial(jax.jit, static_argnames=("num_groups", "aggs",
                                             "key_ordered"))
def _boundary_reduce_cols(skeys, svals, *, num_groups: int, aggs,
                          key_ordered, n_valid=None):
    """Scatter-free segmented reduce over key-sorted rows, N measures.

    The boundary machinery (group starts/ends, the data-dependent
    end-position compaction) runs ONCE and every measure column reduces
    against it. sum/count/mean: group totals are differences of the
    running prefix sum at segment END positions. min/max: when that
    column is key_ordered (rows sorted by (key, value)), a group's
    min/max are the values at its first/last position — pure gathers;
    otherwise a segmented scan (32-bit and f32 values) or one
    (group_id, value) column sort per such column makes them run-boundary
    gathers.

    n_valid: optional traced count of valid rows. When given, rows at
    positions >= n_valid are ignored entirely (callers sort with the
    inverted valid mask as primary key so valid rows form a prefix) —
    validity never has to be encoded in key space, so any key value,
    including the dtype's extremes, aggregates correctly.

    Returns (group_keys, tables tuple, count).
    """
    n = skeys.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    if n_valid is None:
        valid = jnp.ones((n,), jnp.bool_)
    else:
        valid = pos < n_valid
    prev = jnp.concatenate([skeys[:1], skeys[:-1]])
    is_new = valid & jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                      (skeys != prev)[1:]])
    # count needs only the TOTAL of is_new — a reduction, not the full
    # group_id cumsum this used to pay (the 64-bit min/max fallback below
    # materializes group_id itself on the rare path that needs it)
    count = jnp.sum(is_new.astype(jnp.int32))

    # end of group g = position before the next is_new / first invalid row
    # (or the last row)
    ones1 = jnp.ones((1,), jnp.bool_)
    next_is_new = jnp.concatenate([is_new[1:], ones1])
    next_invalid = jnp.concatenate([jnp.logical_not(valid)[1:], ones1])
    is_end = valid & (next_is_new | next_invalid)
    # End position of group g = position of the (g+1)-th end flag. TWO
    # forms, picked by GROUP DENSITY:
    #   * sparse groups (num_groups << n): binary search over the
    #     running end count — O(num_groups * log n) gathers, two-level
    #     (a 4096:1 decimated haystack, then bounded in-block steps);
    #   * dense groups (num_groups ~ n, e.g. the rollup's per-key
    #     aggregate at n/8 distinct keys): the gather bill scales with
    #     num_groups, so one n-row single-column sort of the end
    #     positions (`(!is_end)*n + pos`) takes its place.
    gi = jax.lax.broadcasted_iota(jnp.int32, (num_groups,), 0)
    dense_groups = num_groups * 64 >= n and 2 * n < 2 ** 31
    if dense_groups:
        comb = psort.flag_pos_key(
            jnp.int32(1) - is_end.astype(jnp.int32), n)
        spos_ends = psort.sort_i32_cols((comb,))[0]
        take_g = jnp.minimum(gi, n - 1)
        ends_all = jnp.take(spos_ends, take_g)  # = g-th end position
    else:
        end_rank = _csum(is_end, jnp.int32)
        ends_all = _searchsorted_2level(end_rank, gi + 1, n)
    valid_g = gi < count
    ends = jnp.where(valid_g, jnp.minimum(ends_all, n - 1), n - 1)
    group_keys = jnp.take(skeys, ends)
    starts_g = jnp.concatenate([jnp.zeros((1,), jnp.int32), ends[:-1] + 1])

    vcnt_acc = None
    if any(a in ("count", "mean") for a in aggs):
        vcnt_acc = _csum(valid, jnp.int32)

    def seg_diff(acc):
        end_acc = jnp.take(acc, ends)
        prev_acc = jnp.concatenate([jnp.zeros((1,), end_acc.dtype),
                                    end_acc[:-1]])
        return jnp.where(valid_g, end_acc - prev_acc,
                         jnp.zeros((), end_acc.dtype))

    tables = []
    group_id = None  # built once, on the first 64-bit/f16 min/max
    for sv, agg, ko in zip(svals, aggs, key_ordered):
        if agg in ("min", "max") and ko:
            src = ends if agg == "max" else jnp.clip(starts_g, 0, n - 1)
            tables.append(jnp.where(
                valid_g, jnp.take(sv, src),
                jnp.asarray(_init_scalar(sv.dtype, agg), sv.dtype)))
            continue
        if agg in ("min", "max"):
            # values in arbitrary within-group order: an INCLUSIVE
            # segmented min/max scan restarted at each group boundary
            # makes the value at a group's END position its group
            # min/max (ops/scan/segmented.py). Invalid rows sit past every
            # group's end position, so their values never reach a gathered
            # slot. 64-bit and half-precision values take one
            # (group_id, value) column sort instead.
            if _seg_ok(sv.dtype):
                from cl_ops_tpu.ops.scan.segmented import segmented_scan_1d
                seg = segmented_scan_1d(
                    sv, is_new.astype(jnp.int32), op=agg, exclusive=False)
                tables.append(jnp.where(
                    valid_g, jnp.take(seg, ends).astype(sv.dtype),
                    jnp.asarray(_init_scalar(sv.dtype, agg), sv.dtype)))
                continue
            vl = keymod.to_limbs(sv)
            if group_id is None:
                group_id = _csum(is_new, jnp.int32) - 1
            gid2 = jnp.where(valid, group_id, jnp.int32(num_groups))
            out = psort.sort_i32_cols((gid2, *vl))
            sv2 = keymod.from_limbs(list(out[1:]), sv.dtype)
            gi2 = jax.lax.broadcasted_iota(jnp.int32, (num_groups,), 0)
            s = jnp.searchsorted(out[0], gi2).astype(jnp.int32)
            e = jnp.searchsorted(out[0], gi2,
                                 side="right").astype(jnp.int32) - 1
            src = e if agg == "max" else s
            tables.append(jnp.where(
                valid_g, jnp.take(sv2, jnp.clip(src, 0, n - 1)),
                jnp.asarray(_init_scalar(sv.dtype, agg), sv.dtype)))
            continue
        if agg == "count":
            tables.append(seg_diff(vcnt_acc))
            continue
        if n_valid is not None:
            sv = jnp.where(valid, sv, jnp.zeros((), sv.dtype))
        table = seg_diff(_csum(sv))
        if agg == "mean":
            cnts = jnp.maximum(seg_diff(vcnt_acc), 1)
            table = table / cnts.astype(table.dtype)
        tables.append(table)
    return group_keys, tuple(tables), count
