"""gselect — global-memory selection sort (rank by counting), parity C6.

Mirrors the reference's O(n^2) selection sort
(`src/cl_ops/sort/clo_sort_gselect.cl:38-57`): each element's output
position is the count of elements that sort before it, with the stable
tie-break `(key_i == key_g) && (i < g)` (`clo_sort_gselect.cl:51`) realized
here by appending the element index as a final comparison limb — which also
makes every rank unique, so the final placement is a unique-index scatter
(the reference's `data_out[pos] = elem`, `clo_sort_gselect.cl:56`).

The O(n^2) compare runs as XLA-fused (chunked) broadcast comparisons — the
idiomatic dense-vector form of the reference's per-work-item count
loop. Like the reference, this is only sensible for small n; it exists for
algorithm parity and as a second oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cl_ops_tpu.ops.sort.abstract import SortImplDef, sort_impls
from cl_ops_tpu.utils.bits import cdiv


def _lex_lt_mat(a: tuple, b: tuple):
    """Strict lexicographic less-than, broadcasting a vs b."""
    lt = a[0] < b[0]
    eq = a[0] == b[0]
    for aa, bb in zip(a[1:], b[1:]):
        lt = lt | (eq & (aa < bb))
        eq = eq & (aa == bb)
    return lt


def _make_gselect_sorter(spec, options):
    chunk = int(options.get("chunk", 4096))

    def fn(limbs, payload):
        n = limbs[0].shape[0]
        idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
        # ALWAYS tiebreak on the row index: it keeps ranks unique (the
        # scatter below would silently drop rows on rank collisions) and
        # realizes the stable `(key_i == key_g) && (i < g)` comparison
        # (clo_sort_gselect.cl:51). The payload rides along, unordered.
        keys = tuple(limbs) + (idx,)

        c = min(chunk, n)
        n_chunks = cdiv(n, c)
        padded = n_chunks * c
        # Pads get max key + max index: never counted as less than any real
        # element (i32-max key ties resolve via the index limb).
        pkeys = [jnp.pad(k, (0, padded - n), constant_values=0x7FFFFFFF)
                 for k in keys]

        def body(ci, rank):
            cols = tuple(
                jax.lax.dynamic_slice_in_dim(k, ci * c, c)[None, :]
                for k in pkeys)
            rows = tuple(k[:, None] for k in keys)
            # [key_j < key_i] for j in chunk, i over all rows
            lt = _lex_lt_mat(cols, rows)
            return rank + jnp.sum(lt, axis=1, dtype=jnp.int32)

        rank = jax.lax.fori_loop(0, n_chunks, body,
                                 jnp.zeros((n,), jnp.int32))
        routed = tuple(limbs) + ((payload,) if payload is not None else ())
        out = tuple(
            jnp.zeros_like(a).at[rank].set(a, unique_indices=True,
                                           mode="promise_in_bounds")
            for a in routed)
        out_limbs = out[:len(limbs)]
        out_payload = out[len(limbs)] if payload is not None else None
        return out_limbs, out_payload

    jitted = jax.jit(fn)

    def dispatch(limbs, payload):
        return jitted(limbs, payload)

    return dispatch


sort_impls.register("gselect")(lambda: SortImplDef(
    name="gselect",
    in_place=False,  # parity: ref gselect is out-of-place
    make_limb_sorter=_make_gselect_sorter,
    kernel_names=("gselect_rank",),
    localmem_usage=lambda k, n, o: 0,
))
