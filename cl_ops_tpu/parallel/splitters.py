"""Skew-aware repartitioning: sampled splitters + range exchange.

The north star calls for "skew-aware repartitioning" (BASELINE.json): hash
partitioning balances only when keys are uniform; under Zipf-style skew some
chips drown. The classic fix (sample sort / parallel databases): every chip
contributes a deterministic sample of its keys, all chips compute the same
equal-frequency range splitters from the gathered sample, and rows route by
`searchsorted(splitters, key)` — each chip then owns an equal *fraction of
rows*, not an equal fraction of key space.

Deterministic: samples are strided (not random) and every chip computes
identical splitters from the same all_gathered sample.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cl_ops_tpu.parallel.mesh import (DATA_AXIS, mesh_program, put_sharded,
                                      replicated_sum_int)
from cl_ops_tpu.parallel.shuffle import partition_exchange


def hash_partition_ids(keys, n_chips: int):
    """Hash partition id in [0, n_chips) (Fibonacci hash high bits)."""
    from cl_ops_tpu.ops.exec.join import hash_u32
    from cl_ops_tpu.utils.bits import log2_floor
    bits = log2_floor(n_chips)
    if bits == 0:
        return jnp.zeros(keys.shape, jnp.int32)
    return hash_u32(keys, bits)


def keyed_exchange_replan(sides, mesh: Mesh, *, capacities,
                          axis: str = DATA_AXIS, partition: str = "hash",
                          max_replan: int = 3, samples_per_chip: int = 256,
                          splitter_side: int | None = None,
                          op_name: str = "keyed_exchange"):
    """Partition-exchange keyed relations together, re-planning on overflow.

    Every side routes by the SAME function of its key column, so equal keys
    from all sides land on the same chip — the join/aggregate co-location
    invariant (the reference's analog of explicit aux-capacity accounting:
    `clo_sort_satradix.c:242-257` sizes its buffers and never drops).

    Args:
      sides: sequence of (keys, extra_cols) pairs, all row-sharded.
      capacities: per-side starting (src chip -> partition) bucket bounds.
      partition: "hash" (Fibonacci-hash high bits) or "range"
        (equal-frequency splitters from a strided key sample).
      splitter_side: which side's keys feed plan_splitters (default: the
        longest side — row balance matters most where the rows are).

    The `dropped` counters partition_exchange returns are CHECKED here (one
    host sync per attempt). On any overflow the plan escalates: hash
    switches to range splitters (skew balances by row count, not key
    space); next the splitter sample quadruples; after that every
    overflowing side's capacity DOUBLES per attempt (a single key heavier
    than one bucket cannot be split — only capacity absorbs it).
    Capacity-doubling rounds keep the partition plan fixed, so sides that
    did not overflow reuse their previous shuffle instead of re-running
    the all_to_all. After `max_replan` escalations with rows still
    dropping, raises RuntimeError: rows are never silently lost.

    Returns (results, final_capacities): results[i] = (counts, out_keys,
    *out_cols) for side i in partition_exchange's bucket layout, with
    final_capacities[i] the bucket bound actually used.
    """
    if partition not in ("hash", "range"):
        raise ValueError(f"unknown partition {partition!r}")
    n_chips = mesh.shape[axis]
    caps = list(capacities)
    if splitter_side is None:
        splitter_side = max(range(len(sides)),
                            key=lambda i: sides[i][0].shape[0])
    mode = partition
    attempt = 0
    resampled = False
    plan_v = 0
    pids = None
    cache: dict = {}  # side -> (plan_v, cap, result, drop)
    while True:
        if pids is None:
            if mode == "hash":
                pids = [hash_partition_ids(k, n_chips) for k, _ in sides]
            else:
                spl = plan_splitters(sides[splitter_side][0], mesh,
                                     samples_per_chip=samples_per_chip,
                                     axis=axis)
                pids = [jnp.searchsorted(spl, k).astype(jnp.int32)
                        for k, _ in sides]
        results, drops = [], []
        for i, ((k, cols), pid) in enumerate(zip(sides, pids)):
            hit = cache.get(i)
            if hit is not None and hit[0] == plan_v and hit[1] == caps[i]:
                res, drop = hit[2], hit[3]
            else:
                counts, dropped, *outs = partition_exchange(
                    k, pid, mesh, capacity=caps[i], axis=axis,
                    extra_cols=cols)
                res = (counts, *outs)
                drop = replicated_sum_int(dropped, mesh)
                cache[i] = (plan_v, caps[i], res, drop)
            results.append(res)
            drops.append(drop)
        if not any(drops):
            return results, tuple(caps)
        if attempt >= max_replan:
            raise RuntimeError(
                f"{op_name}: shuffle overflow persists after {attempt} "
                f"re-plans (dropped rows per side: {drops}, capacities "
                f"{caps}); raise the capacity bounds")
        attempt += 1
        if mode == "hash":
            mode = "range"  # skew-aware: balance row counts, not key space
            plan_v += 1
            pids = None
        elif not resampled:
            samples_per_chip *= 4
            resampled = True
            plan_v += 1
            pids = None
        else:  # plan fixed: only the overflowing sides re-shuffle
            caps = [c * 2 if d else c for c, d in zip(caps, drops)]


def keyed_exchange_once(sides, mesh: Mesh, *, capacities,
                        axis: str = DATA_AXIS, partition: str = "hash",
                        samples_per_chip: int = 256,
                        splitter_side: int | None = None):
    """Single-attempt keyed partition exchange — fully traceable.

    The steady-state sibling of keyed_exchange_replan: one shuffle per side
    under a fixed plan, NO host synchronization. The `dropped` counters come
    back as device arrays (one per-chip count per side) for the caller to
    check asynchronously — the right shape for jit-compiled serving
    pipelines where a blocking host read per query is unaffordable and
    capacities were already validated (e.g. by a planning call through
    keyed_exchange_replan on representative data).

    Returns (results, dropped): results[i] = (counts, out_keys, *out_cols)
    in partition_exchange's bucket layout; dropped[i] is side i's per-chip
    drop count (all zeros ⇔ the exchange was exact).
    """
    if partition not in ("hash", "range"):
        raise ValueError(f"unknown partition {partition!r}")
    n_chips = mesh.shape[axis]
    if splitter_side is None:
        splitter_side = max(range(len(sides)),
                            key=lambda i: sides[i][0].shape[0])
    if partition == "hash":
        pids = [hash_partition_ids(k, n_chips) for k, _ in sides]
    else:
        spl = plan_splitters(sides[splitter_side][0], mesh,
                             samples_per_chip=samples_per_chip, axis=axis)
        pids = [jnp.searchsorted(spl, k).astype(jnp.int32)
                for k, _ in sides]
    results, drops = [], []
    for (k, cols), pid, cap in zip(sides, pids, capacities):
        counts, dropped, *outs = partition_exchange(
            k, pid, mesh, capacity=cap, axis=axis, extra_cols=cols)
        results.append((counts, *outs))
        drops.append(dropped)
    return results, tuple(drops)


def plan_splitters(keys, mesh: Mesh, *, samples_per_chip: int = 256,
                   axis: str = DATA_AXIS):
    """Compute n_chips-1 equal-frequency splitters from a strided sample.

    Returns a replicated (n_chips-1,) array of splitter keys: partition p
    takes keys in (splitter[p-1], splitter[p]] boundaries via searchsorted.
    """
    n_chips = mesh.shape[axis]

    fn = mesh_program(_local_splitters, mesh, P(axis), P(),
                      n_chips=n_chips, samples_per_chip=samples_per_chip,
                      axis=axis)
    return fn(put_sharded(keys, mesh, axis))


def range_partition_exchange(data, splitters, mesh: Mesh, *, capacity: int,
                             axis: str = DATA_AXIS, extra_cols=()):
    """Route rows by range: part_id = searchsorted(splitters, key).

    With splitters from plan_splitters this is the skew-aware shuffle —
    row counts per chip stay balanced for any key distribution the sample
    captures. Same return convention as partition_exchange.
    """
    part = jnp.searchsorted(splitters, data).astype(jnp.int32)
    return partition_exchange(data, part, mesh, capacity=capacity, axis=axis,
                              extra_cols=extra_cols)


def dist_sort_sample(x, mesh: Mesh, *, capacity_factor: float = 2.0,
                     samples_per_chip: int = 256, axis: str = DATA_AXIS,
                     max_resample: int = 2):
    """Sample sort across the mesh: splitters -> range exchange -> local sort.

    The scalable alternative to the hypercube bitonic dist_sort: one
    all_to_all instead of log^2(P) ppermute rounds.

    Returns (totals, sorted_buf, dropped), all row-sharded per chip:
    chip c holds totals[c] valid rows sorted ascending at the front of its
    (n_chips*capacity)-long slice of sorted_buf (entries past totals[c] are
    unspecified), and all of chip c's keys precede chip c+1's.
    capacity_factor sizes the per-bucket headroom over the uniform share.
    Skew beyond the sample's resolution would drop rows; the planner
    detects that (`dropped` counter) and re-plans with 4x the samples, up
    to `max_resample` times, before letting rows drop — check the
    returned `dropped` per chip. (Duplicate-heavy keys where one key
    exceeds a bucket's capacity cannot be fixed by sampling; raise
    capacity_factor for those.)
    """
    n_chips = mesh.shape[axis]
    n = x.shape[0]
    shard_len = n // n_chips
    capacity = int(capacity_factor * shard_len / n_chips) + 1
    attempt = 0
    while True:
        splitters = plan_splitters(x, mesh,
                                   samples_per_chip=samples_per_chip,
                                   axis=axis)
        counts, dropped, buf = range_partition_exchange(
            x, splitters, mesh, capacity=capacity, axis=axis)
        if attempt >= max_resample:
            break
        if replicated_sum_int(dropped, mesh) == 0:
            break
        samples_per_chip *= 4  # adaptive re-sample on overflow
        attempt += 1

    fn = mesh_program(_local_sample_sort, mesh, P(axis), (P(axis), P(axis)),
                      n_chips=n_chips, capacity=capacity)
    sorted_buf, totals = fn(put_sharded(counts, mesh, axis),
                            put_sharded(buf, mesh, axis))
    return totals, sorted_buf, dropped


def _local_splitters(k, *, n_chips, samples_per_chip, axis):
    """Strided sample of one chip's keys; splitters from the gathered
    sample (identical on every chip)."""
    k = k.reshape(-1)
    m = k.shape[0]
    stride = max(m // samples_per_chip, 1)
    idx = (jnp.arange(samples_per_chip, dtype=jnp.int32) * stride) % m
    sample = jnp.sort(jnp.take(k, idx))
    allsamp = jax.lax.all_gather(sample, axis).reshape(-1)
    allsamp = jnp.sort(allsamp)
    total = allsamp.shape[0]
    pick = (jnp.arange(1, n_chips, dtype=jnp.int32) * total) // n_chips
    return jnp.take(allsamp, pick)


def _local_sample_sort(c, b, *, n_chips, capacity):
    """One chip's sort of the rows it received in the range exchange."""
    c = c.reshape(-1)
    b = b.reshape(n_chips, capacity)
    slot = jax.lax.broadcasted_iota(jnp.int32, b.shape, 1)
    valid = (slot < c[:, None]).reshape(-1)
    # Validity as primary sort key (not a key-space sentinel): valid
    # rows form the sorted prefix for ANY key dtype/value; the trailing
    # invalid slots are unspecified.
    inv = jnp.logical_not(valid).astype(jnp.int32)
    _, sk = jax.lax.sort([inv, b.reshape(-1)], num_keys=2)
    total = jnp.sum(c, dtype=jnp.int32)
    return sk, total.reshape(1)
