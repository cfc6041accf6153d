"""Scalar type registry.

JAX re-expression of the reference's CloType system
(`src/cl_ops/common/clo_common.c:54-124`, `clo_common.in.h:108-145`): a table of
the 11 OpenCL scalar types with name <-> dtype <-> size mappings, plus the
elem->sum widening rule used by the scan family
(`src/cl_ops/scan/clo_scan_abstract.c:74-168` passes separate elem/sum types).

Unlike the reference (string-spliced `-D` macros into OpenCL C), specialization
here happens through jit static arguments keyed on `jnp.dtype`.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax.numpy as jnp
import numpy as np

DTypeLike = Union[str, np.dtype, type]


@dataclasses.dataclass(frozen=True)
class TypeInfo:
    """One scalar type: OpenCL-style name, numpy dtype, and size in bytes."""

    name: str           # OpenCL-style name, e.g. "uint" (clo_common.c:54-68)
    dtype: np.dtype     # canonical numpy dtype
    size: int           # sizeof in bytes
    is_integer: bool
    is_signed: bool


def _ti(name: str, np_dtype, signed: bool, integer: bool = True) -> TypeInfo:
    d = np.dtype(np_dtype)
    return TypeInfo(name=name, dtype=d, size=d.itemsize,
                    is_integer=integer, is_signed=signed)


# Mirrors the 11-entry clo_type_info table (clo_common.c:54-68).
_TYPE_TABLE: tuple[TypeInfo, ...] = (
    _ti("char", np.int8, True),
    _ti("uchar", np.uint8, False),
    _ti("short", np.int16, True),
    _ti("ushort", np.uint16, False),
    _ti("int", np.int32, True),
    _ti("uint", np.uint32, False),
    _ti("long", np.int64, True),
    _ti("ulong", np.uint64, False),
    _ti("half", np.float16, True, integer=False),
    _ti("float", np.float32, True, integer=False),
    _ti("double", np.float64, True, integer=False),
)

_BY_NAME = {t.name: t for t in _TYPE_TABLE}
_BY_DTYPE = {t.dtype: t for t in _TYPE_TABLE}

# An extra not present in the reference's table: bfloat16, first-class in JAX.
_BY_NAME["bfloat16"] = TypeInfo("bfloat16", np.dtype(jnp.bfloat16), 2,
                                is_integer=False, is_signed=True)
_BY_DTYPE[np.dtype(jnp.bfloat16)] = _BY_NAME["bfloat16"]


def all_type_names() -> list[str]:
    """Names of the 11 reference-parity scalar types (clo_common.c:54-68)."""
    return [t.name for t in _TYPE_TABLE]


def type_by_name(name: str) -> TypeInfo:
    """Name -> TypeInfo, like clo_type_by_name (clo_common.c:108-124)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown type name {name!r}; known: {sorted(_BY_NAME)}") from None


def canonicalize(dt: DTypeLike) -> np.dtype:
    """Accept an OpenCL-style name, numpy dtype, or python type -> np.dtype."""
    if isinstance(dt, str) and dt in _BY_NAME:
        return _BY_NAME[dt].dtype
    return np.dtype(dt)


def type_info(dt: DTypeLike) -> TypeInfo:
    d = canonicalize(dt)
    try:
        return _BY_DTYPE[d]
    except KeyError:
        raise KeyError(f"dtype {d} is not in the scalar type registry") from None


def type_name(dt: DTypeLike) -> str:
    """dtype -> OpenCL-style name, like clo_type_get_name (clo_common.c:78-92)."""
    return type_info(dt).name


def type_sizeof(dt: DTypeLike) -> int:
    """dtype -> size in bytes, like clo_type_sizeof (clo_common.c:95-105)."""
    return type_info(dt).size


def default_sum_dtype(elem_dtype: DTypeLike) -> np.dtype:
    """Widening rule for scan sums (elem type -> accumulator type).

    The reference lets the caller pick any sum type >= elem type
    (clo_scan_bench defaults uint -> ulong, clo_scan_bench.c:26-31); we default
    to the next wider type of the same kind, capped at 64 bits.
    """
    t = type_info(elem_dtype)
    if not t.is_integer:
        # float16/bfloat16 accumulate in float32; float32/64 keep their width.
        return np.dtype(np.float32) if t.size <= 2 else t.dtype
    width = min(t.size * 2, 8)
    kind = "i" if t.is_signed else "u"
    return np.dtype(f"{kind}{width}")


def unsigned_equivalent(dt: DTypeLike) -> np.dtype:
    """Unsigned integer dtype of the same width (for radix key bit tricks)."""
    t = type_info(dt)
    return np.dtype(f"u{t.size}")
