"""Join: fact-table probe against a keyed build side.

North-star operator (BASELINE.json: "Distributed hash join: 1B-row fact x
100M-row dim"). No referent in the reference library. Single-chip strategy
is a sorted build side probed by binary search (probe.py) or, as the
alternative, a sort-merge rank of build ++ probe; the distributed strategy
hash-partitions both sides over the mesh with all_to_all so each chip
joins only its partition (parallel/ layer).

Semantics:
  * unique build keys (dimension-table case): (found, vals) per probe.
  * non-unique build keys: (match_count, first_vals) per probe — the
    bounded-output compromise (full expansion has no static shape).
  * hash_join_expand: all matching pairs under a static capacity bound,
    with the true total reported for overflow re-runs.
  * join_type "inner" | "semi" | "anti": semi/anti return only the mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cl_ops_tpu.ops.exec import psort
from cl_ops_tpu.ops.exec.probe import search_build
from cl_ops_tpu.ops.sort import keys as keymod

_I32_MIN = -0x80000000
_I32_MAX = 0x7FFFFFFF
# packed pos*2+eq restore keys stay exact while 2m < _PACK_MAX; beyond it
# restores use an extra column. Module-level so tests can shrink it.
_PACK_MAX = 2 ** 31
PROBE_IMPLS = ("auto", "direct", "merge")


@functools.partial(jax.jit, static_argnames=("sorted_output",))
def _merge_rank(build_limbs, build_vcols, probe_limbs,
                    sorted_output: bool = False):
    """Counts-and-gathers core of the merge-join probe.

    Keys are tuples of normalized i32 limbs (keys.py — 1 for 32-bit, 2 for
    64-bit). One sort of the build ++ probe concatenation, with build rows
    tagged to sort before equal probes: a probe's merged position minus
    its rank among probes = count of build keys <= the probe key.
    Everything is sorts, a prefix rank and monotone gathers.

    Returns (counts, eq, val_prev, val_next, spos) — as search_build's
    fields (probe.py) — in original probe order with spos=None, or, with
    sorted_output, in probe-key-sorted order (skipping the restore sort)
    with spos = original probe row per output row."""
    nl = len(build_limbs)
    nb = build_limbs[0].shape[0]
    m = probe_limbs[0].shape[0]
    nt = nb + m
    limb_cols = tuple(jnp.concatenate([b, p])
                      for b, p in zip(build_limbs, probe_limbs))
    tag = jnp.concatenate([jnp.zeros((nb,), jnp.int32),
                           jnp.ones((m,), jnp.int32)])
    srcs = jnp.concatenate([
        jnp.zeros((nb,), jnp.int32),
        jax.lax.broadcasted_iota(jnp.int32, (m,), 0)])
    out1 = jax.lax.sort([*limb_cols, tag, srcs], num_keys=nl + 1)
    s_limbs, st, ssrc = out1[:nl], out1[nl], out1[nl + 1]
    pos = jax.lax.broadcasted_iota(jnp.int32, (nt,), 0)
    _, probe_pos, probe_src = jax.lax.sort(
        [1 - st, pos, ssrc], num_keys=1, is_stable=True)
    probe_pos = probe_pos[:m]
    probe_src = probe_src[:m]
    rank = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    counts = probe_pos - rank              # build keys <= probe key
    idx = jnp.clip(counts - 1, 0, nb - 1)
    nxt = jnp.clip(counts, 0, nb - 1)
    val_prev = tuple(jnp.take(v, idx) for v in build_vcols)
    val_next = tuple(jnp.take(v, nxt) for v in build_vcols)
    eq = counts > 0
    for bl, sl in zip(build_limbs, s_limbs):
        eq = eq & (jnp.take(bl, idx) == jnp.take(sl, probe_pos))
    nv = len(val_prev)
    if sorted_output:
        # rows are already grouped by probe key; probe_src maps each
        # output row to its original probe row — no restore sort needed
        return counts, eq, val_prev, val_next, probe_src
    if 2 * m < _PACK_MAX:
        # back to original probe order; eq rides the low bit of the key
        key3 = probe_src * 2 + eq.astype(jnp.int32)
        out = jax.lax.sort([key3, counts, *val_prev, *val_next],
                           num_keys=1)
        return (out[1], (out[0] & 1) > 0, tuple(out[2:2 + nv]),
                tuple(out[2 + nv:]), None)
    # two-limb restore past the packed-key limit: probe_src is unique,
    # so eq rides as an inert column (m can reach 2^31)
    out = jax.lax.sort(
        [probe_src, eq.astype(jnp.int32), counts, *val_prev, *val_next],
        num_keys=1)
    return (out[2], out[1] > 0, tuple(out[3:3 + nv]),
            tuple(out[3 + nv:]), None)


def _limbs_minus_one(limbs):
    """key - 1 in normalized limb space; also returns the is-minimum mask."""
    if len(limbs) == 1:
        lo = limbs[0]
        is_min = lo == jnp.int32(_I32_MIN)
        return (jnp.where(is_min, lo, lo - 1),), is_min
    hi, lo = limbs
    lo_min = lo == jnp.int32(_I32_MIN)
    new_lo = jnp.where(lo_min, jnp.int32(_I32_MAX), lo - 1)
    new_hi = jnp.where(lo_min, hi - 1, hi)
    is_min = lo_min & (hi == jnp.int32(_I32_MIN))
    return (jnp.where(is_min, hi, new_hi),
            jnp.where(is_min, lo, new_lo)), is_min


def _val_cols(build_vals):
    """Value column(s) as i32 (two limb columns for 8-byte dtypes), so
    every strategy moves i32 columns only."""
    return psort.cols_to_i32((build_vals,))[0]


def _val_from_cols(cols, dtype):
    """Inverse of _val_cols for gathered value columns."""
    return psort.cols_from_i32(tuple(cols), (jnp.dtype(dtype),))[0]


def _probe_strategy(probe_impl: str) -> str:
    """Resolve "auto" to the concrete probe strategy."""
    if probe_impl not in PROBE_IMPLS:
        raise ValueError(f"unknown probe_impl {probe_impl!r}; known: "
                         f"{PROBE_IMPLS}")
    return "direct" if probe_impl == "auto" else probe_impl


def _sort_probes(plimbs, extra_cols=()):
    """Probes sorted by (key, position): (spos, sorted limbs, sorted extra
    columns). The position makes the order total, so extra columns ride
    as payload."""
    m = plimbs[0].shape[0]
    nl = len(plimbs)
    pos = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    sp = psort.sort_i32_cols((*plimbs, pos, *extra_cols), num_keys=nl + 1)
    return sp[nl], tuple(sp[:nl]), tuple(sp[nl + 1:])


def _bounds(bl, vcols, qlimbs):
    """(upper bound, lower bound, first-match value columns) per query:
    rows lb..ub-1 of the sorted build side match. The lower bound is the
    upper bound of key-1 in limb space (key == limb minimum: 0)."""
    ub, _, _, _ = search_build(bl, vcols, qlimbs)
    qm1, is_min = _limbs_minus_one(qlimbs)
    lb, _, _, vns = search_build(bl, vcols, qm1)
    # minimum-key probes: the key-1 pass's val_next points past the
    # match run — the first match is slot 0 of each value column
    first = tuple(jnp.where(is_min, v[0], c) for v, c in zip(vcols, vns))
    return ub, jnp.where(is_min, 0, lb), first


@functools.partial(jax.jit, static_argnames=("strat", "sorted_output"))
def _probe_unique(bl, vcols, plimbs, probe_cols_enc, *, strat: str,
                  sorted_output: bool):
    """Unique-build-key probe: (found, val cols, spos|None, pcols|None).

    direct: a binary search per probe, in original probe order; with
    sorted_output the probes (and their payload columns) are sorted
    first. merge: the sort-merge rank."""
    if strat == "direct":
        if not sorted_output:
            _, eq, vp, _ = search_build(bl, vcols, plimbs)
            return eq, vp, None, None
        spos, sp_limbs, scols = _sort_probes(plimbs, probe_cols_enc)
        _, eq, vp, _ = search_build(bl, vcols, sp_limbs)
        return eq, vp, spos, scols
    _, eq, val_prev, _, spos = _merge_rank(bl, vcols, plimbs,
                                           sorted_output=sorted_output)
    return eq, val_prev, spos, None


@functools.partial(jax.jit, static_argnames=("strat", "sorted_output"))
def _probe_multi(bl, vcols, plimbs, probe_cols_enc, *, strat: str,
                 sorted_output: bool):
    """Non-unique probe: (match_count, first-match val cols, spos|None,
    pcols|None). Upper bound (#build <= key) minus lower bound (#build <
    key, the upper bound of key-1 in limb space)."""
    if strat == "direct":
        if not sorted_output:
            ub, lb, first = _bounds(bl, vcols, plimbs)
            return ub - lb, first, None, None
        spos, sp_limbs, scols = _sort_probes(plimbs, probe_cols_enc)
        ub, lb, first = _bounds(bl, vcols, sp_limbs)
        return ub - lb, first, spos, scols
    # Merge: its two passes sort probes INDEPENDENTLY, by key and by
    # key-1, and those orders can interleave differently where min and
    # min+1 keys coexist (key-1 ties them) — so sorted_output cannot skip
    # the restores here; compute in original order first.
    ub, _, _, _, _ = _merge_rank(bl, vcols, plimbs)
    pm1, is_min = _limbs_minus_one(plimbs)
    lb, _, _, vns, _ = _merge_rank(bl, vcols, pm1)
    count = ub - jnp.where(is_min, 0, lb)
    first = tuple(jnp.where(is_min, v[0], c) for v, c in zip(vcols, vns))
    if not sorted_output:
        return count, first, None, None
    # honor the grouped-output contract with one key sort ((limbs, pos)
    # is a total order, so the grouping is deterministic)
    m = plimbs[0].shape[0]
    nl = len(plimbs)
    pos = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    out = psort.sort_i32_cols((*plimbs, pos, count, *first),
                              num_keys=nl + 1)
    return out[nl + 1], tuple(out[nl + 2:]), out[nl], None


def hash_join(build_keys, build_vals, probe_keys, *, build_sorted=False,
              sorter=None, unique_build: bool = True, join_type: str = "inner",
              probe_impl: str = "auto", sorted_output: bool = False,
              probe_cols=(), defer_overflow: bool = False):
    """Equi-join probe of the fact side against the build side.

    Args:
      build_keys: keys of the build (dimension) side.
      build_vals: values carried per build key (int/float of 1, 2, 4 or 8
        bytes; they ride as i32 columns, psort.cols_to_i32).
      probe_keys: fact-side keys to look up.
      build_sorted: set True when build_keys are already ascending.
      sorter: registry Sorter for the build side (default "xla").
      unique_build: build keys are unique (dimension-table case).
      join_type: "inner" | "semi" | "anti".
      probe_impl: "auto" (= "direct") | "direct" | "merge". "direct"
        binary-searches the sorted build side per probe (probe.py);
        "merge" ranks probes in one sort of build ++ probe.
      sorted_output: return a THIRD element `probe_rows` and skip the
        restore sorts — output rows come back GROUPED IN ASCENDING
        PROBE-KEY ORDER on every strategy (aggregate consumers may rely on
        keys_sorted=True downstream) and probe_rows[i] is the original
        probe row of output row i. Consumers that re-sort anyway
        (aggregates) or carry several probe columns should pass True.
      probe_cols: extra probe-side payload columns (fact measures etc.),
        returned reordered to match the output rows (requires
        sorted_output). On the direct strategy they ride the probe sort
        itself; on merge they reorder through probe_rows.
      defer_overflow: appends a trailing device bool, the serving form's
        overflow flag (the single-chip analog of the distributed
        operators' check="defer"). No strategy can overflow, so it is
        always False; the slot stays for callers that check it.

    Every strategy is jit-traceable.

    Returns:
      inner + unique_build: (found, vals) — vals undefined where not
        found.
      inner + not unique_build: (match_count, first_vals) — the value of
        the FIRST match in build-key-sorted order (full expansion has no
        static shape; bound it with match_count).
      semi: bool mask of probes with >= 1 match.
      anti: bool mask of probes with no match.
      With sorted_output=True every form gains a trailing `probe_rows`
      array (the original probe row per output row) and rows arrive
      grouped in ascending probe-key order; with probe_cols the
      reordered payload columns follow as one trailing tuple. With
      defer_overflow=True the overflow flag is appended LAST.
    """
    if join_type not in ("inner", "semi", "anti"):
        raise ValueError(f"unknown join_type {join_type!r}")
    if probe_cols and not sorted_output:
        raise ValueError("probe_cols requires sorted_output=True (in "
                         "original order the inputs are already aligned)")
    strat = _probe_strategy(probe_impl)
    if not build_sorted:
        sorter = sorter or _default_build_sorter(
            jnp.dtype(build_keys.dtype).name)
        build_keys, build_vals = sorter.sort_with_device_data(
            build_keys, build_vals)
    pc_enc, pc_spec = (psort.cols_to_i32(tuple(probe_cols))
                       if probe_cols else ((), ()))
    bl = tuple(keymod.to_limbs(build_keys))
    plimbs = tuple(keymod.to_limbs(probe_keys))
    vcols = _val_cols(build_vals)
    probe = _probe_unique if unique_build else _probe_multi
    first, vals, spos, scols = probe(bl, vcols, plimbs, pc_enc, strat=strat,
                                     sorted_output=sorted_output)
    vals = _val_from_cols(vals, build_vals.dtype)
    found = first if unique_build else first > 0
    out_cols = ()
    if probe_cols:
        if scols is None:  # strategy did not carry them: one gather each
            scols = tuple(jnp.take(c, spos) for c in pc_enc)
        out_cols = (psort.cols_from_i32(scols, pc_spec),)
    if join_type == "semi":
        out = (found,)
    elif join_type == "anti":
        out = (jnp.logical_not(found),)
    else:
        out = (first, vals)
    if sorted_output:
        out = out + (spos, *out_cols)
    if defer_overflow:
        out = out + (jnp.zeros((), jnp.bool_),)
    return out[0] if len(out) == 1 else out


@functools.lru_cache(maxsize=None)
def _default_build_sorter(dtype):
    from cl_ops_tpu.ops.sort import sort_new
    return sort_new("xla", elem_dtype=dtype)


@functools.partial(jax.jit, static_argnames=("strat",))
def _ranges_sorted(bl, vcols, plimbs, *, strat: str):
    """Per-SORTED-probe match ranges: (spos, ub, lb).

    ub/lb are the searchsorted right/left bounds into the sorted build
    side; rows lb..ub-1 are the probe's matches, and probes come out in
    (key, position) order.
    """
    if strat == "direct":
        spos, sp_limbs, _ = _sort_probes(plimbs)
        ub, lb, _ = _bounds(bl, vcols, sp_limbs)
        return spos, ub, lb
    ub, _, _, _, _ = _merge_rank(bl, vcols, plimbs)
    pm1, is_min = _limbs_minus_one(plimbs)
    lb, _, _, _, _ = _merge_rank(bl, vcols, pm1)
    lb = jnp.where(is_min, 0, lb)
    m = plimbs[0].shape[0]
    nl = len(plimbs)
    pos = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    out = psort.sort_i32_cols((*plimbs, pos, ub, lb), num_keys=nl + 1)
    return out[nl], out[nl + 1], out[nl + 2]


@functools.partial(jax.jit, static_argnames=("capacity",))
def _expand_from_ranges(spos, ub, lb, svcols, capacity: int):
    """Distribute match ranges over `capacity` output rows.

    Output row r belongs to the sorted probe j whose cumulative match
    count first exceeds r; its build row is lb[j] + (r - prefix_excl[j]).
    Both lookups are monotone in r (zero-count probes are skipped by the
    searchsorted-right semantics).
    """
    counts = ub - lb
    prefix_inc = jnp.cumsum(counts, dtype=jnp.int32)
    m = counts.shape[0]
    nb = svcols[0].shape[0]
    total = prefix_inc[m - 1]
    r = jnp.arange(capacity, dtype=jnp.int32)
    j = jnp.searchsorted(prefix_inc, r, side="right").astype(jnp.int32)
    jc = jnp.minimum(j, m - 1)
    cj = jnp.take(counts, jc)
    pij = jnp.take(prefix_inc, jc)
    off = r - (pij - cj)
    bpos = jnp.clip(jnp.take(lb, jc) + off, 0, nb - 1)
    vals = tuple(jnp.take(v, bpos) for v in svcols)
    pidx = jnp.take(spos, jc)
    valid = r < jnp.minimum(total, jnp.int32(capacity))
    pidx = jnp.where(valid, pidx, jnp.int32(-1))
    return total, pidx, vals


def hash_join_expand(build_keys, build_vals, probe_keys, *, capacity: int,
                     build_sorted=False, sorter=None,
                     probe_impl: str = "auto"):
    """Emit ALL matching (probe row, build value) pairs, capacity-bounded.

    The full inner-join expansion `hash_join` cannot return (no static
    shape): every probe row appears once per matching build row. Output
    rows are ordered by (probe key, original probe position), matches of
    one probe contiguous in sorted-build order.

    Args:
      capacity: static output length. When the true match total exceeds
        it the output is TRUNCATED — check `total` and re-run with a
        larger capacity (the same contract as partition_exchange's
        fixed-capacity buckets).
      (other args as `hash_join`.)

    Returns:
      (total, probe_idx, vals): `total` (i32 scalar) counts all matches;
      `probe_idx`/`vals` are `(capacity,)` arrays — row r < min(total,
      capacity) holds one match pair (original probe row index, build
      value); rows beyond hold probe_idx == -1.
    """
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    if probe_keys.shape[0] == 0 or build_keys.shape[0] == 0:
        return (jnp.int32(0), jnp.full((capacity,), -1, jnp.int32),
                jnp.zeros((capacity,), build_vals.dtype))
    strat = _probe_strategy(probe_impl)
    if not build_sorted:
        sorter = sorter or _default_build_sorter(
            jnp.dtype(build_keys.dtype).name)
        build_keys, build_vals = sorter.sort_with_device_data(
            build_keys, build_vals)
    vcols = _val_cols(build_vals)
    spos, ub, lb = _ranges_sorted(tuple(keymod.to_limbs(build_keys)), vcols,
                                  tuple(keymod.to_limbs(probe_keys)),
                                  strat=strat)
    total, pidx, vals = _expand_from_ranges(spos, ub, lb, vcols, capacity)
    return total, pidx, _val_from_cols(vals, build_vals.dtype)


@functools.partial(jax.jit, static_argnames=("table_bits",))
def hash_u32(keys, table_bits: int):
    """Multiplicative hash of u32/i32 keys into [0, 2^table_bits).

    The partition hash for the distributed shuffle (Fibonacci constant).
    """
    k = keys.astype(jnp.uint32)
    return ((k * jnp.uint32(2654435769)) >> jnp.uint32(32 - table_bits)
            ).astype(jnp.int32)
