"""XLA-native sort implementation ("xla"): lax.sort on normalized limbs.

The registry's known-good baseline — the analog of picking a vendor routine.
It is also the correctness oracle the other impls are tested against, the
way the reference benchmarks verify against a serial host pass
(`src/benchmarks/clo_sort_bench.c:216-227`). Stable (is_stable=True), so
payload order among equal keys is preserved like the reference's gselect
tie-break (`clo_sort_gselect.cl:51`).
"""

from __future__ import annotations

import functools

import jax

from cl_ops_tpu.ops.sort.abstract import SortImplDef, sort_impls


def _make_limb_sorter(spec, options):
    @jax.jit
    def run(limbs, payload):
        ops = list(limbs) + [payload]
        out = jax.lax.sort(ops, num_keys=len(limbs), is_stable=True)
        return tuple(out[:len(limbs)]), out[len(limbs)]

    @jax.jit
    def run_no_payload(limbs):
        out = jax.lax.sort(list(limbs), num_keys=len(limbs), is_stable=True)
        return tuple(out), None

    def dispatch(limbs, payload):
        if payload is None:
            return run_no_payload(limbs)
        return run(limbs, payload)

    return dispatch


sort_impls.register("xla")(lambda: SortImplDef(
    name="xla",
    in_place=False,
    make_limb_sorter=_make_limb_sorter,
    kernel_names=("lax_sort",),
    localmem_usage=lambda k, n, o: 0,
))
