"""Flagship end-to-end query pipelines.

The "model" of this framework is an operator pipeline (SURVEY.md §7: "one
model running end-to-end ≈ one operator pipeline: RNG-generate -> sort ->
verify"). Two flagships:

  sort_pipeline    — Threefry-generate keys -> sort -> sortedness stats.
                     The minimum end-to-end slice from SURVEY.md §7 stage 4.
  analytics_query  — generate a (key, value) fact table -> filter rows ->
                     GROUP BY aggregate; the north-star query shape
                     (filter + hash aggregate over RNG data,
                     BASELINE.json configs 3-4).

Both are pure jittable functions so the driver can compile-check them and
shard them over a mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cl_ops_tpu.ops.rng import threefry
from cl_ops_tpu.ops.exec import aggregate as agg
from cl_ops_tpu.ops.exec import filter as flt


def generate_table(n: int, seed: int = 0, key_space: int = 1 << 20,
                   value_space: int = 1 << 10):
    """Threefry-generated (keys, values) fact table (clo_rng replacement)."""
    ids = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
    keys = threefry.random_bits(seed, ids, jnp.uint32(0)) % jnp.uint32(
        key_space)
    values = threefry.random_bits(seed, ids, jnp.uint32(1)) % jnp.uint32(
        value_space)
    return keys, values


@functools.partial(jax.jit, static_argnames=("n", "seed", "impl"))
def sort_pipeline(n: int, seed: int = 0, impl: str = "xla"):
    """Generate n random keys, sort them with the registry sorter `impl`,
    return (sorted, is_sorted)."""
    from cl_ops_tpu.ops.sort import sort_new
    keys, _ = generate_table(n, seed)
    # jit-compatible: the sorter's limb path is itself jitted
    sorted_keys = sort_new(impl).sort_with_device_data(keys)
    ok = jnp.all(sorted_keys[1:] >= sorted_keys[:-1])
    return sorted_keys, ok


@functools.partial(jax.jit,
                   static_argnames=("n", "num_groups", "seed", "threshold"))
def analytics_query(n: int, num_groups: int = 1024, seed: int = 0,
                    threshold: int = 512):
    """SELECT key % G, SUM(value) FROM t WHERE value < threshold GROUP BY 1.

    The north-star query shape: RNG scan -> predicate filter (compaction
    by one stable-partition sort) -> prefix group-by aggregate (boundary
    reduce over the compacted prefix). Returns the
    table in ascending group-key order with a count of surviving rows.
    """
    keys, values = generate_table(n, seed)
    count, fvals, fkeys = flt.filter_compact(
        values, lambda v: v < jnp.uint32(threshold), keys)
    gids = (fkeys % jnp.uint32(num_groups)).astype(jnp.int32)
    kb = max((num_groups - 1).bit_length(), 1)  # gids < num_groups
    gk, tbl, gcnt = agg.group_aggregate_prefix(
        gids, fvals.astype(jnp.uint32), count, num_groups=num_groups,
        agg="sum", key_bits=kb if kb <= 30 else None)
    # re-index by group id (a num_groups-sized scatter, not an n-sized one)
    slot = jax.lax.broadcasted_iota(jnp.int32, (num_groups,), 0)
    gk = jnp.where(slot < gcnt, gk, jnp.int32(num_groups))
    table = jnp.zeros((num_groups,), tbl.dtype).at[gk].set(tbl, mode="drop")
    return count, table


@functools.partial(jax.jit,
                   static_argnames=("n", "dim_rows", "num_cats", "seed",
                                    "threshold", "probe_impl"))
def star_query(n: int, dim_rows: int = 1 << 14, num_cats: int = 256,
               seed: int = 0, threshold: int = 512,
               probe_impl: str = "auto"):
    """SELECT d.cat, SUM(f.value) FROM fact f JOIN dim d ON f.key = d.key
    WHERE f.value < threshold GROUP BY d.cat — the full star-schema shape.

    Composes every exec operator: RNG scan -> filter+compaction -> hash
    join (probe_impl as in hash_join) -> prefix group-by over the joined
    dimension attribute, all in one jit.
    """
    from cl_ops_tpu.ops.exec import join as jn
    keys, values = generate_table(n, seed, key_space=dim_rows)
    dim_keys = jax.lax.broadcasted_iota(jnp.uint32, (dim_rows,), 0)
    dim_cat = (threefry.random_bits(seed + 1, dim_keys, jnp.uint32(2))
               % jnp.uint32(num_cats)).astype(jnp.int32)
    count, fvals, fkeys = flt.filter_compact(
        values, lambda v: v < jnp.uint32(threshold), keys)
    _, cats = jn.hash_join(dim_keys, dim_cat, fkeys, build_sorted=True,
                           probe_impl=probe_impl)
    kb = max((num_cats - 1).bit_length(), 1)  # cats < num_cats
    gk, tbl, gcnt = agg.group_aggregate_prefix(
        cats, fvals.astype(jnp.uint32), count, num_groups=num_cats,
        agg="sum", key_bits=kb if kb <= 30 else None)
    slot = jax.lax.broadcasted_iota(jnp.int32, (num_cats,), 0)
    gk = jnp.where(slot < gcnt, gk, jnp.int32(num_cats))
    table = jnp.zeros((num_cats,), tbl.dtype).at[gk].set(tbl, mode="drop")
    return count, table


@functools.partial(jax.jit,
                   static_argnames=("n", "num_groups", "seed", "threshold"))
def q1_query(n: int, num_groups: int = 64, seed: int = 0,
             threshold: int = 768):
    """SELECT key, SUM(qty), SUM(price), MIN(qty), MAX(price), COUNT(*),
    AVG(price) FROM t WHERE qty < threshold GROUP BY key — the TPC-H-Q1
    shape: a multi-measure aggregate over a filtered scan, in ONE jit.

    Exercises group_aggregate_cols end-to-end in its FUSED filter form:
    the WHERE mask packs into the key column (valid_mask= with key_bits=),
    so the pipeline pays ONE (validity|key, qty, price) sort total — no
    separate filter_compact partition. All six aggregates reduce against
    one shared boundary scan (MIN(qty) and MAX(price) through one
    segmented scan each).

    Returns (count, group_keys, tables, group_count): tables is the
    6-tuple of aggregate columns in the SELECT order above.
    """
    from cl_ops_tpu.ops.exec import aggregate as agm
    ids = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
    keys = (threefry.random_bits(seed, ids, jnp.uint32(0))
            % jnp.uint32(num_groups)).astype(jnp.int32)
    qty = (threefry.random_bits(seed, ids, jnp.uint32(1))
           % jnp.uint32(1024)).astype(jnp.int32)
    price = (threefry.random_bits(seed, ids, jnp.uint32(2))
             % jnp.uint32(10000)).astype(jnp.int32)
    mask = qty < jnp.int32(threshold)
    count = jnp.sum(mask.astype(jnp.int32))
    # keys < num_groups by construction -> the WHERE mask packs into the
    # key column (key_bits): a 3-column sort instead of 4
    kb = max((num_groups - 1).bit_length(), 1)
    gk, tables, gcnt = agm.group_aggregate_cols(
        keys, (qty, price, qty, price, qty, price),
        ("sum", "sum", "min", "max", "count", "mean"),
        num_groups=num_groups, valid_mask=mask,
        key_bits=kb if kb <= 30 else None)
    return count, gk, tables, gcnt


@functools.partial(jax.jit,
                   static_argnames=("n", "dim_rows", "seed", "probe_impl"))
def rollup_query(n: int, dim_rows: int = 1 << 20, seed: int = 0,
                 probe_impl: str = "auto"):
    """SELECT f.key, SUM(f.measure) FROM fact f SEMI JOIN dim d
    ON f.key = d.key GROUP BY f.key — the big-dimension rollup.

    The restore-free composition: the join emits probe rows in key-sorted
    order (sorted_output) with the fact measure and the key itself riding
    along as payload columns, and the aggregate consumes them with
    keys_sorted=True — no join restore sort, no aggregate input sort.

    Returns (group_keys, sums, count): per distinct matched fact key, the
    sum of its measures over rows whose key exists in dim (even keys by
    construction); unmatched rows contribute zero and their keys report a
    zero-sum group.
    """
    from cl_ops_tpu.ops.exec import join as jn
    keys, measures = generate_table(n, seed, key_space=2 * dim_rows)
    measures = measures.astype(jnp.int32)
    dim_keys = jax.lax.broadcasted_iota(jnp.uint32, (dim_rows,), 0) * 2
    dim_vals = jax.lax.broadcasted_iota(jnp.int32, (dim_rows,), 0)
    found, _, _, (m_s, k_s) = jn.hash_join(
        dim_keys, dim_vals, keys, build_sorted=True, sorted_output=True,
        probe_impl=probe_impl, probe_cols=(measures, keys))
    contrib = jnp.where(found, m_s, jnp.int32(0))
    return agg.group_aggregate_sorted(
        k_s, contrib, num_groups=2 * dim_rows, agg="sum", keys_sorted=True)
