"""Bitonic sorter implementations: "sbitonic" and "abitonic".

Both run Batcher's bitonic network on normalized key limbs, written in
plain `lax`: one compare-exchange step (stage size K, distance J) views the
pow-2-padded columns as (n / 2J, 2, J), compares each row of the middle
axis with its partner lexicographically, and swaps the pair where the
block's direction (ascending where (i & K) == 0) says so. A swap moves
whole rows, so payload columns stay attached to their keys.

sbitonic — parity with the reference's simple bitonic sorter
(`src/cl_ops/sort/clo_sort_sbitonic.c:102-118,224-233`): one jitted
dispatch per (stage, step), issued from a host loop like the reference's
one kernel launch per step.

abitonic — parity with the reference's advanced bitonic sorter
(`clo_sort_abitonic.c:58-313`), whose point is running many steps per
launch: here the whole network is one jit.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp

from cl_ops_tpu.ops.sort.abstract import SortImplDef, sort_impls
from cl_ops_tpu.utils.bits import log2_floor, nlpo2

# i32 max: pads sort after every real key; pad payloads also get this value
# so key-equal ties against padding resolve real-before-pad.
_PAD = 0x7FFFFFFF

# Strategy-trace logging, the g_debug parity of the reference's chosen-
# kernel dumps (clo_sort_abitonic.c:398-409). Enable with
# logging.getLogger("cl_ops_tpu").setLevel(logging.DEBUG).
_log = logging.getLogger("cl_ops_tpu.sort")


def lex_lt(a: tuple, b: tuple):
    """Strict lexicographic a < b over tuples of i32 columns."""
    lt = a[-1] < b[-1]
    for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
        lt = (x < y) | ((x == y) & lt)
    return lt


def cx_step(cols: tuple, *, k: int, j: int, num_keys: int) -> tuple:
    """One bitonic compare-exchange step over pow-2-length columns.

    Rows i and i + j (i & j == 0) are partners; a block of k rows sorts
    ascending where (i & k) == 0 and descending otherwise. Only the first
    num_keys columns are compared.
    """
    n = cols[0].shape[0]
    g = n // (2 * j)
    pairs = [c.reshape(g, 2, j) for c in cols]
    lo = tuple(p[:, 0, :] for p in pairs)
    hi = tuple(p[:, 1, :] for p in pairs)
    asc = ((jnp.arange(g, dtype=jnp.int32) * (2 * j)) & k) == 0
    swap = jnp.where(asc[:, None], lex_lt(hi[:num_keys], lo[:num_keys]),
                     lex_lt(lo[:num_keys], hi[:num_keys]))
    return tuple(
        jnp.stack([jnp.where(swap, h, l), jnp.where(swap, l, h)],
                  axis=1).reshape(n)
        for l, h in zip(lo, hi))


def network(n: int):
    """The (k, j) steps of the bitonic network over n (a power of 2)."""
    for sk in range(1, log2_floor(n) + 1):
        k = 1 << sk
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2


def _pad(cols, n: int):
    padded = nlpo2(n)
    if padded == n:
        return tuple(cols), padded
    return tuple(jnp.pad(c, (0, padded - n), constant_values=_PAD)
                 for c in cols), padded


@functools.partial(jax.jit, static_argnames=("num_keys",))
def _abitonic(cols, num_keys: int):
    n = cols[0].shape[0]
    for k, j in network(n):
        cols = cx_step(cols, k=k, j=j, num_keys=num_keys)
    return cols


_sbitonic_step = jax.jit(cx_step, static_argnames=("k", "j", "num_keys"))


def _make_bitonic_sorter(fused: bool):
    def make(spec, options):
        del spec, options

        def dispatch(limbs, payload):
            cols = tuple(limbs) + ((payload,) if payload is not None else ())
            n = cols[0].shape[0]
            cols, padded = _pad(cols, n)
            # A payload column only moves, unless padding could tie a real
            # all-i32-max key row with the pad rows on the key prefix.
            nk = len(limbs) if padded == n else len(cols)
            _log.debug("%s: n=%d padded=%d columns=%d",
                       "abitonic" if fused else "sbitonic", n, padded,
                       len(cols))
            if fused:
                cols = _abitonic(cols, nk)
            else:
                for k, j in network(padded):
                    cols = _sbitonic_step(cols, k=k, j=j, num_keys=nk)
            cols = tuple(c[:n] for c in cols)
            return (cols[:len(limbs)],
                    cols[len(limbs)] if payload is not None else None)
        return dispatch
    return make


sort_impls.register("sbitonic")(lambda: SortImplDef(
    name="sbitonic",
    in_place=True,  # parity flag: ref sbitonic sorts in place
    make_limb_sorter=_make_bitonic_sorter(fused=False),
    kernel_names=("cx_step",),
    localmem_usage=lambda k, n, o: 0,
))

sort_impls.register("abitonic")(lambda: SortImplDef(
    name="abitonic",
    in_place=True,
    make_limb_sorter=_make_bitonic_sorter(fused=True),
    kernel_names=("network",),
    localmem_usage=lambda k, n, o: 0,
))
