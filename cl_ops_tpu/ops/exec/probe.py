"""Join probe: binary search of probe keys over a sorted build side.

Per probe key p the join wants the searchsorted-right count (#build rows
<= p), whether the build row just below that bound equals p, and the build
values on both sides of the bound. Keys are tuples of normalized i32 limbs
(keys.py: one limb for 32-bit keys, two for 64-bit), compared
lexicographically, so the search is written over limbs: a fixed number of
halving steps, each one gather per limb. A 1M-row build side (4-8 MB of
keys) sits in the GPU's L2 cache, where those gathers are cheap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lex_le(a_limbs, b_limbs):
    """Lexicographic a <= b over tuples of i32 limb columns."""
    le = a_limbs[-1] <= b_limbs[-1]
    for a, b in zip(reversed(a_limbs[:-1]), reversed(b_limbs[:-1])):
        le = (a < b) | ((a == b) & le)
    return le


def count_leq(build_limbs, probe_limbs):
    """#build rows <= each probe (build ascending): searchsorted-right."""
    nb = build_limbs[0].shape[0]
    m = probe_limbs[0].shape[0]
    lo = jnp.zeros((m,), jnp.int32)
    hi = jnp.full((m,), nb, jnp.int32)
    # the answer lies in [lo, hi]: nb + 1 candidates, nb.bit_length() halvings
    for _ in range(nb.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        midc = jnp.minimum(mid, nb - 1)
        le = lex_le(tuple(jnp.take(b, midc) for b in build_limbs),
                    probe_limbs)
        lo = jnp.where(active & le, mid + 1, lo)
        hi = jnp.where(active & jnp.logical_not(le), mid, hi)
    return lo


@jax.jit
def search_build(build_limbs, build_vals, probe_limbs):
    """Probe a sorted build side.

    Args:
      build_limbs: tuple of ascending build key limb columns (nb,).
      build_vals: tuple of build value columns (nb,), any dtype.
      probe_limbs: tuple of probe key limb columns (m,), any order.

    Returns (count, eq, val_prev, val_next) per probe: count = #build
    rows <= probe; eq = count > 0 and build row count-1 equals the probe;
    val_prev[k] = build_vals[k][count-1] and val_next[k] =
    build_vals[k][count], both clamped into [0, nb).
    """
    nb = build_limbs[0].shape[0]
    count = count_leq(build_limbs, probe_limbs)
    idx = jnp.clip(count - 1, 0, nb - 1)
    nxt = jnp.clip(count, 0, nb - 1)
    eq = count > 0
    for b, p in zip(build_limbs, probe_limbs):
        eq = eq & (jnp.take(b, idx) == p)
    val_prev = tuple(jnp.take(v, idx) for v in build_vals)
    val_next = tuple(jnp.take(v, nxt) for v in build_vals)
    return count, eq, val_prev, val_next


def search_traffic_bytes(m: int, n_limbs: int, n_vals: int) -> int:
    """Least bytes a search of m probes moves: probe limbs read once,
    count/eq and two gathered value columns per value written once (the
    build side is assumed cache-resident)."""
    return 4 * m * (n_limbs + 2 + 2 * n_vals)
