"""Sort abstract class: named impls, key specialization, host/device entry.

JAX re-expression of the reference's sort abstraction
(`src/cl_ops/sort/clo_sort_abstract.c:91-418`, `.in.h:43-170`):

  - named implementation registry (`clo_sort_abstract.c:110-121`)
  - per-object specialization on (elem type, key type, comparator, key
    extractor) — the reference splices `CLO_SORT_ELEM_TYPE` /
    `CLO_SORT_KEY_TYPE` / `CLO_SORT_COMPARE(a,b)` / `CLO_SORT_KEY_GET(x)`
    macros into OpenCL C (`clo_sort_abstract.c:144-168`); here the key
    extractor is a traced Python callable and the comparator is the
    (ascending, key-normalization) pair — see keys.py
  - `sort_with_device_data` / `sort_with_host_data` entry points
    (`clo_sort_abstract.in.h:116-143`), extended with an optional values
    array (the satradix key-value benchmark config, BASELINE.json)
  - kernel introspection: num kernels / names / local-mem usage
    (`clo_sort_abstract.in.h:147-170`) and the per-impl `in_place` flag
    (`clo_sort_abstract.in.h:48`).

Pipeline shared by all impls: keys are normalized to order-preserving u32
limbs (keys.py); impls sort limb tuples plus an optional u32 payload; when
the payload is a row index, the final reorder of elems/values happens via an
XLA gather. Descending order = sorting bitwise-complemented limbs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cl_ops_tpu.core.dtypes import canonicalize
from cl_ops_tpu.core.errors import BadArgsError
from cl_ops_tpu.core.registry import Registry, parse_options
from cl_ops_tpu.ops.sort import keys as keymod


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """Static specialization of one sorter object."""

    elem_dtype: np.dtype
    key_dtype: np.dtype
    ascending: bool
    has_key_fn: bool  # True when a custom key extractor is used


@dataclasses.dataclass(frozen=True)
class SortImplDef:
    """Vtable analog of CloSortImplDef (clo_sort_abstract.in.h:43-110).

    make_limb_sorter(spec, options) returns
      fn(limbs: tuple[i32 array, ...], payload: i32 array | None)
        -> (sorted_limbs, sorted_payload)
    operating on normalized key limbs; payload rides along untouched.
    """

    name: str
    in_place: bool
    make_limb_sorter: Callable[..., Callable]
    kernel_names: tuple[str, ...]
    localmem_usage: Callable[[str, int, dict], int]


sort_impls: Registry[SortImplDef] = Registry("sort")


class Sorter:
    """A specialized sorter (analog of `struct clo_sort`)."""

    def __init__(self, impl: SortImplDef, spec: SortSpec,
                 key_fn: Optional[Callable], options: dict[str, str]):
        self._impl = impl
        self.spec = spec
        self._key_fn = key_fn
        self._options = options
        self._limb_sorter = impl.make_limb_sorter(spec, options)
        # One end-to-end jit per (n, values dtype): key normalization, the
        # sort and key restoration dispatch as a single call.
        self._jit_cache: dict = {}

    # -- introspection (parity: clo_sort_abstract.in.h:147-170) --------------
    @property
    def name(self) -> str:
        return self._impl.name

    @property
    def in_place(self) -> bool:
        return self._impl.in_place

    @property
    def elem_dtype(self) -> np.dtype:
        return self.spec.elem_dtype

    @property
    def key_dtype(self) -> np.dtype:
        return self.spec.key_dtype

    @property
    def num_kernels(self) -> int:
        return len(self._impl.kernel_names)

    def kernel_name(self, i: int) -> str:
        return self._impl.kernel_names[i]

    def localmem_usage(self, kernel_name: str, numel: int) -> int:
        return self._impl.localmem_usage(kernel_name, numel, self._options)

    # -- entry points --------------------------------------------------------
    def sort_with_device_data(self, data: jax.Array, values=None):
        """Sort a device array, optionally carrying a values array.

        Returns sorted data, or (sorted data, reordered values) when values
        is given. Parity: clo_sort_with_device_data
        (clo_sort_abstract.c:256-273) + KV extension.
        """
        if data.ndim != 1:
            raise BadArgsError(f"sort expects 1-D input, got {data.shape}")
        if jnp.dtype(data.dtype) != self.spec.elem_dtype:
            raise BadArgsError(
                f"input dtype {data.dtype} != specialized elem dtype "
                f"{self.spec.elem_dtype}")
        if values is not None and values.shape[0] != data.shape[0]:
            raise BadArgsError("values length must match data length")

        if self._key_fn is not None:
            # Validate the key extractor's dtype eagerly (outside the jit)
            # so the error is a BadArgsError, not a trace-time surprise.
            probe = jax.eval_shape(self._key_fn, data)
            if jnp.dtype(probe.dtype) != self.spec.key_dtype:
                raise BadArgsError(
                    f"key_fn produced dtype {probe.dtype}, expected "
                    f"{self.spec.key_dtype}")

        ck = (data.shape[0],
              None if values is None else jnp.dtype(values.dtype))
        if ck not in self._jit_cache:
            if values is None:
                self._jit_cache[ck] = jax.jit(
                    lambda d: self._sort_traced(d, None))
            else:
                self._jit_cache[ck] = jax.jit(self._sort_traced)
        if values is None:
            return self._jit_cache[ck](data)
        return self._jit_cache[ck](data, values)

    def _sort_traced(self, data, values):
        """Whole sort as one traceable body (jitted by the entry point)."""
        raw_keys = self._key_fn(data) if self._key_fn is not None else data
        limbs = keymod.to_limbs(raw_keys)
        if not self.spec.ascending:
            limbs = [~l for l in limbs]  # complement reverses unsigned order

        def restore_keys(sorted_limbs):
            if not self.spec.ascending:
                sorted_limbs = [~l for l in sorted_limbs]
            return keymod.from_limbs(list(sorted_limbs),
                                     self.spec.elem_dtype)

        if values is None and self._key_fn is None and len(limbs) == 1:
            sorted_limbs, _ = self._limb_sorter(tuple(limbs), None)
            return restore_keys(sorted_limbs)

        # 4-byte values with the identity key ride the sort directly as the
        # payload, saving the two n-row gathers of a permutation apply.
        vdt = jnp.dtype(values.dtype) if values is not None else None
        if (values is not None and self._key_fn is None
                and vdt.itemsize == 4):
            pay = (values if vdt == jnp.int32
                   else jax.lax.bitcast_convert_type(values, jnp.int32))
            sorted_limbs, spay = self._limb_sorter(tuple(limbs), pay)
            svals = (spay if vdt == jnp.int32
                     else jax.lax.bitcast_convert_type(spay, vdt))
            return restore_keys(sorted_limbs), svals

        n = data.shape[0]
        payload = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
        _, perm = self._limb_sorter(tuple(limbs), payload)
        out = jnp.take(data, perm)
        if values is None:
            return out
        return out, jnp.take(values, perm)

    def sort_with_host_data(self, data, values=None):
        """Host round trip (parity: clo_sort_with_host_data,
        clo_sort_abstract.c:296-418)."""
        dev = jax.device_put(np.asarray(data, self.spec.elem_dtype))
        if values is None:
            out = self.sort_with_device_data(dev)
            return np.asarray(jax.block_until_ready(out))
        vdev = jax.device_put(np.asarray(values))
        out, vout = self.sort_with_device_data(dev, vdev)
        jax.block_until_ready((out, vout))
        return np.asarray(out), np.asarray(vout)

    __call__ = sort_with_device_data


def sort_new(name: str = "satradix",
             options: str | dict[str, Any] | None = None,
             elem_dtype="uint", key_dtype=None,
             key_fn: Optional[Callable] = None,
             ascending: bool = True) -> Sorter:
    """Create a sorter by name (parity: clo_sort_new, clo_sort_abstract.c:91).

    Args:
      name: "sbitonic" | "abitonic" | "gselect" | "satradix" | "xla".
      options: reference-style option string/dict (e.g. "radix=16" for
        satradix, `clo_sort_satradix.c:353`).
      elem_dtype: element type of the array being sorted.
      key_dtype: ordering key type; defaults to elem_dtype (the reference's
        default key = the element itself, clo_sort_abstract.c:156-160).
      key_fn: traced key extractor elem -> key (CLO_SORT_KEY_GET analog).
      ascending: sort direction (CLO_SORT_COMPARE "<" vs ">").
    """
    impl = sort_impls.get(name)()
    ed = canonicalize(elem_dtype)
    kd = canonicalize(key_dtype) if key_dtype is not None else ed
    if key_fn is None and kd != ed:
        raise BadArgsError("key_dtype differs from elem_dtype but no key_fn")
    spec = SortSpec(elem_dtype=ed, key_dtype=kd, ascending=ascending,
                    has_key_fn=key_fn is not None)
    return Sorter(impl, spec, key_fn, parse_options(options))


def sort_names() -> list[str]:
    return sort_impls.names()
