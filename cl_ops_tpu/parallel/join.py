"""Distributed hash join: partition-exchange both sides, join locally.

The north-star config ("Distributed hash join: 1B-row fact x 100M-row dim
... 4-host shuffle", BASELINE.json). Both relations partition on the join
key over the mesh (parallel/shuffle.py all_to_all exchange), every chip
joins only its partition, and probe results shuffle back to their origin
rows — deterministic, collective-only communication.

Skew safety: the shuffles' overflow counters are CHECKED (never silently
discarded). Under Zipf-skewed keys whose hash buckets overflow, the plan
escalates to skew-aware range splitters and, if one key alone outweighs a
bucket, to doubled capacities (splitters.keyed_exchange_replan); persistent
overflow raises instead of losing rows. The reference's referent for this
explicit capacity accounting is `clo_sort_satradix.c:242-257`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cl_ops_tpu.parallel.mesh import (DATA_AXIS, iota_sharded, mesh_program,
                                      put_sharded)
from cl_ops_tpu.parallel.splitters import (hash_partition_ids,
                                           keyed_exchange_once,
                                           keyed_exchange_replan)
from cl_ops_tpu.utils.bits import is_po2

def _key_partition(keys, n_chips: int):
    return hash_partition_ids(keys, n_chips)


def dist_hash_join(build_keys, build_vals, probe_keys, mesh: Mesh, *,
                   capacity_build: int, capacity_probe: int,
                   axis: str = DATA_AXIS, unique_build: bool = True,
                   join_type: str = "inner", partition: str = "hash",
                   max_replan: int = 3, samples_per_chip: int = 256,
                   check: str = "replan"):
    """Equi-join of row-sharded relations.

    capacity_* bound rows per (source chip -> partition) bucket in the two
    shuffles (static shapes). Overflowing buckets trigger an adaptive
    re-plan (hash -> range splitters -> doubled capacities, see
    keyed_exchange_replan) and raise if rows would still drop — the join
    never silently loses rows under skew.

    partition: "hash" or "range" (start from skew-aware splitters sampled
    from the probe side — the right opener for known-Zipf fact keys).
    check: "replan" (default) validates the shuffles' overflow counters on
      the host and adaptively re-plans — never loses rows, but costs one
      blocking host read per side per attempt and cannot run under jax.jit.
      "defer" runs ONE exchange under the given plan with no host sync and
      appends the per-side per-chip `dropped` counters to the outputs —
      fully traceable (jit/steady-state serving path); the CALLER must
      verify the counters are zero for the result to be exact (plan
      capacities beforehand, e.g. with a check="replan" call on
      representative data).

    All outputs are row-sharded and aligned with probe_keys' original
    layout:
      inner + unique_build:     (found, vals)
      inner + not unique_build: (match_count, first_vals) — value of the
        first match in build-key order (bounded-output compromise)
      semi / anti:              the match / no-match mask alone
    With check="defer" the tuple gains a trailing element
    (dropped_build, dropped_probe).
    """
    if join_type not in ("inner", "semi", "anti"):
        raise ValueError(f"unknown join_type {join_type!r}")
    if check not in ("replan", "defer"):
        raise ValueError(f"unknown check {check!r}")
    n_chips = mesh.shape[axis]
    if not is_po2(n_chips):
        raise ValueError("mesh axis size must be a power of 2")
    n_probe = probe_keys.shape[0]
    shard_len = n_probe // n_chips

    # 1+2. shuffle both sides by the same key partition, carrying build
    # values / global probe row ids; re-plan adaptively on overflow.
    gidx = iota_sharded(n_probe, mesh, axis)
    if check == "defer":
        (bres, pres), dropped = keyed_exchange_once(
            [(build_keys, (build_vals,)), (probe_keys, (gidx,))], mesh,
            capacities=(capacity_build, capacity_probe), axis=axis,
            partition=partition, samples_per_chip=samples_per_chip,
            splitter_side=1)
        cb, cp = capacity_build, capacity_probe
    else:
        (bres, pres), (cb, cp) = keyed_exchange_replan(
            [(build_keys, (build_vals,)), (probe_keys, (gidx,))], mesh,
            capacities=(capacity_build, capacity_probe), axis=axis,
            partition=partition, max_replan=max_replan,
            samples_per_chip=samples_per_chip, splitter_side=1,
            op_name="dist_hash_join")
    bcounts, bk, bv = bres
    pcounts, pk, pg = pres

    # 3. local join per chip + route results back by origin chip
    fn = mesh_program(_local_join, mesh, P(axis), (P(axis), P(axis)),
                      n_chips=n_chips, cb=cb, cp=cp, shard_len=shard_len,
                      axis=axis)
    cnt, vals = fn(*(put_sharded(a, mesh, axis)
                     for a in (bcounts, bk, bv, pcounts, pk, pg)))
    if join_type == "semi":
        out = (cnt > 0,)
    elif join_type == "anti":
        out = (cnt == 0,)
    elif unique_build:
        out = (cnt > 0, vals)
    else:
        out = (cnt, vals)
    if check == "defer":
        out = out + (dropped,)
    return out[0] if len(out) == 1 else out


def dist_hash_join_expand(build_keys, build_vals, probe_keys, mesh: Mesh, *,
                          capacity_build: int, capacity_probe: int,
                          capacity_out: int, axis: str = DATA_AXIS,
                          partition: str = "hash", max_replan: int = 3,
                          samples_per_chip: int = 256,
                          check: str = "replan"):
    """Distributed FULL inner-join expansion: all matching pairs.

    The multi-chip `hash_join_expand`: both relations co-partition by key
    (same adaptive skew re-planning as dist_hash_join), every chip expands
    its partition locally, and outputs STAY partition-sharded — expansion
    rows belong to their key's partition; there is no per-probe-row
    alignment to route back to.

    capacity_out bounds output PAIRS PER CHIP (static shapes). Returns
    (totals, probe_rows, vals), all row-sharded: chip c's slice holds
    totals[c] true matches for its partition; its first
    min(totals[c], capacity_out) output rows each hold (original global
    probe row, build value), ordered by (key, arrival order); rows beyond
    hold probe_rows == -1. totals[c] > capacity_out means that chip's
    output was truncated — re-run with a larger capacity_out.

    check: "replan" (default) or "defer" — same contract as dist_hash_join;
    "defer" is jit-traceable and appends (dropped_build, dropped_probe).
    """
    n_chips = mesh.shape[axis]
    if not is_po2(n_chips):
        raise ValueError("mesh axis size must be a power of 2")
    if check not in ("replan", "defer"):
        raise ValueError(f"unknown check {check!r}")
    n_probe = probe_keys.shape[0]
    gidx = iota_sharded(n_probe, mesh, axis)
    if check == "defer":
        (bres, pres), dropped = keyed_exchange_once(
            [(build_keys, (build_vals,)), (probe_keys, (gidx,))], mesh,
            capacities=(capacity_build, capacity_probe), axis=axis,
            partition=partition, samples_per_chip=samples_per_chip,
            splitter_side=1)
        cb, cp = capacity_build, capacity_probe
    else:
        (bres, pres), (cb, cp) = keyed_exchange_replan(
            [(build_keys, (build_vals,)), (probe_keys, (gidx,))], mesh,
            capacities=(capacity_build, capacity_probe), axis=axis,
            partition=partition, max_replan=max_replan,
            samples_per_chip=samples_per_chip, splitter_side=1,
            op_name="dist_hash_join_expand")
    bcounts, bk, bv = bres
    pcounts, pk, pg = pres

    fn = mesh_program(_local_expand, mesh, P(axis),
                      (P(axis), P(axis), P(axis)), n_chips=n_chips, cb=cb,
                      cp=cp, capacity_out=capacity_out)
    out = fn(*(put_sharded(a, mesh, axis)
               for a in (bcounts, bk, bv, pcounts, pk, pg)))
    return out + (dropped,) if check == "defer" else out


def _local_join(bc, bkl, bvl, pc, pkl, pgl, *, n_chips, cb, cp, shard_len,
                axis):
    """One chip's join of its partition; results go back to origin rows."""
    table_len = n_chips * cb
    bc = bc.reshape(-1)
    pc = pc.reshape(-1)
    bkl = bkl.reshape(n_chips, cb)
    bvl = bvl.reshape(n_chips, cb)
    pkl = pkl.reshape(n_chips, cp)
    pgl = pgl.reshape(n_chips, cp)
    slot_b = jax.lax.broadcasted_iota(jnp.int32, bkl.shape, 1)
    valid_b = slot_b < bc[:, None]
    slot_p = jax.lax.broadcasted_iota(jnp.int32, pkl.shape, 1)
    valid_p = slot_p < pc[:, None]

    # Build a sorted local dim table with validity as the PRIMARY sort
    # key (invalid slots last) — validity never enters key space, so a
    # real key equal to the dtype max still joins correctly.
    inv_b = jnp.logical_not(valid_b).astype(jnp.int32).reshape(-1)
    nv = jnp.sum(bc, dtype=jnp.int32)  # valid build rows (prefix)
    pkey = pkl.reshape(-1)
    # For searchsorted the trailing invalid slots take the dtype max
    # (keeps the array monotone); counts clip at nv so probes equal to
    # that fill never count fill slots.
    _, skey, sval, svalid_i = jax.lax.sort(
        [inv_b, bkl.reshape(-1), bvl.reshape(-1),
         valid_b.astype(jnp.int32).reshape(-1)], num_keys=2)
    svalid = svalid_i > 0
    kdt = jnp.dtype(skey.dtype)
    maxk = (jnp.asarray(jnp.iinfo(kdt).max, kdt)
            if jnp.issubdtype(kdt, jnp.integer)
            else jnp.asarray(jnp.inf, kdt))
    skey = jnp.where(svalid, skey, maxk)
    idx_l = jnp.searchsorted(skey, pkey,
                             side="left").astype(jnp.int32)
    idx_r = jnp.searchsorted(skey, pkey,
                             side="right").astype(jnp.int32)
    val = jnp.take(sval, jnp.minimum(idx_l, table_len - 1))
    cnt = (jnp.minimum(idx_r, nv) - jnp.minimum(idx_l, nv)) \
        * valid_p.reshape(-1).astype(jnp.int32)

    # 4. send (gidx, found, val) back to the origin chip
    g = pgl.reshape(-1)
    origin = jnp.where(valid_p.reshape(-1), g // shard_len,
                       jnp.int32(n_chips))  # invalid rows -> dropped
    # rows received from origin o number <= cp, so cp-sized return
    # buckets can never overflow
    cap_back = cp
    m = g.shape[0]
    order2 = jnp.argsort(origin, stable=True)
    so = jnp.take(origin, order2)
    pos2 = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    start = jnp.searchsorted(so, jnp.arange(
        n_chips, dtype=so.dtype)).astype(jnp.int32)
    rank = pos2 - jnp.take(start, jnp.minimum(so, n_chips - 1))
    dest = jnp.minimum(so, n_chips) * cap_back + rank
    dest = jnp.where((so < n_chips) & (rank < cap_back), dest,
                     n_chips * cap_back)

    def route(col, dtype):
        buf = jnp.zeros((n_chips * cap_back,), dtype).at[dest].set(
            jnp.take(col, order2).astype(dtype), mode="drop",
            unique_indices=True)
        return jax.lax.all_to_all(
            buf.reshape(n_chips, cap_back), axis, split_axis=0,
            concat_axis=0, tiled=False).reshape(-1)

    rg = route(g, jnp.int32)
    rcnt = route(cnt, jnp.int32)
    rval = route(val, val.dtype)
    # mark empty return slots: route a validity flag too
    rvalid = route(jnp.ones((m,), jnp.int32), jnp.int32)

    # 5. scatter into this chip's original row order
    local_rows = shard_len
    li = rg % local_rows
    li = jnp.where(rvalid > 0, li, local_rows)  # drop empty slots
    cnt_out = jnp.zeros((local_rows,), jnp.int32).at[li].set(
        rcnt, mode="drop")
    vals_out = jnp.zeros((local_rows,), rval.dtype).at[li].set(
        rval, mode="drop")
    return cnt_out, vals_out


def _local_expand(bc, bkl, bvl, pc, pkl, pgl, *, n_chips, cb, cp,
                  capacity_out):
    """One chip's full expansion of its partition's matching pairs."""
    from cl_ops_tpu.ops.exec.join import (_expand_from_ranges, _val_cols,
                                          _val_from_cols)
    bc = bc.reshape(-1)
    pc = pc.reshape(-1)
    bkl = bkl.reshape(n_chips, cb)
    bvl = bvl.reshape(n_chips, cb)
    pkl = pkl.reshape(n_chips, cp)
    pgl = pgl.reshape(n_chips, cp)
    slot_b = jax.lax.broadcasted_iota(jnp.int32, bkl.shape, 1)
    valid_b = slot_b < bc[:, None]
    slot_p = jax.lax.broadcasted_iota(jnp.int32, pkl.shape, 1)
    valid_p = (slot_p < pc[:, None]).reshape(-1)

    # sorted local build table: valid rows form the prefix
    inv_b = jnp.logical_not(valid_b).astype(jnp.int32).reshape(-1)
    _, skey, sval = jax.lax.sort(
        [inv_b, bkl.reshape(-1), bvl.reshape(-1)], num_keys=2)
    nv = jnp.sum(bc, dtype=jnp.int32)
    kdt = jnp.dtype(skey.dtype)
    maxk = (jnp.asarray(jnp.iinfo(kdt).max, kdt)
            if jnp.issubdtype(kdt, jnp.integer)
            else jnp.asarray(jnp.inf, kdt))
    pos_b = jax.lax.broadcasted_iota(jnp.int32, skey.shape, 0)
    skey = jnp.where(pos_b < nv, skey, maxk)

    # probes sorted by (validity, key, global row id) — the row id is
    # a KEY so equal-key output order is the documented arrival order,
    # deterministic across backends
    inv_p = jnp.logical_not(valid_p).astype(jnp.int32)
    _, spk, sg, svalid_i = jax.lax.sort(
        [inv_p, pkl.reshape(-1), pgl.reshape(-1),
         valid_p.astype(jnp.int32)], num_keys=3)
    ub = jnp.minimum(jnp.searchsorted(
        skey, spk, side="right").astype(jnp.int32), nv)
    lb = jnp.minimum(jnp.searchsorted(
        skey, spk).astype(jnp.int32), nv)
    ub = jnp.where(svalid_i > 0, ub, 0)
    lb = jnp.where(svalid_i > 0, lb, 0)
    total, pidx, vals = _expand_from_ranges(
        sg, ub, lb, _val_cols(sval), capacity_out)
    return (total.reshape(1), pidx, _val_from_cols(vals, bvl.dtype))
