"""Filter + stream compaction.

North-star operator (BASELINE.json: "Prefix-sum filter: Blelloch scan +
compaction over 64M rows w/ 10% selectivity"). No direct referent in the
reference library; it is the canonical *consumer* of the reference's
primitives — the same composition pattern satradix uses
(`src/cl_ops/sort/clo_sort_satradix.c:296-300` composes a CloScan).

Formulation: compaction is a stable partition — kept rows move to the
front in their original order — done by one stable `jax.lax.sort` keyed on
the dropped flag, the columns riding as they are. The count is a plain
reduction. (A packed unique `(!keep)*n + position` rank key ran as fast
with a payload column and 14% slower without one on the H100; PERF.md.)

XLA has no data-dependent shapes, so compaction returns (count, packed):
`packed` has the input length with kept rows contiguous at the front and
unspecified tail.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("predicate",))
def filter_compact(data, predicate: Callable, *extra_cols):
    """Keep rows where predicate(data) holds, compacted to the front.

    Args:
      data: 1-D array the predicate reads.
      predicate: traced elementwise fn data -> bool mask.
      *extra_cols: additional same-length columns carried through.

    Returns:
      (count, packed_data, *packed_cols) — kept rows in input order;
      elements past `count` are unspecified (the dropped rows' slots).
    """
    mask = predicate(data)
    count = jnp.sum(mask.astype(jnp.int32))
    dropped_key = jnp.logical_not(mask).astype(jnp.int32)
    out = jax.lax.sort([dropped_key, data, *extra_cols], num_keys=1,
                       is_stable=True)
    return (count, *out[1:])


@functools.partial(jax.jit, static_argnames=("predicate",))
def count_where(data, predicate: Callable):
    """Count rows satisfying the predicate (no compaction)."""
    return jnp.sum(predicate(data).astype(jnp.int32))
