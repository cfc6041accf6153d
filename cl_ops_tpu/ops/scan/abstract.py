"""Scan abstract class: named impls, dtype specialization, host/device entry.

JAX re-expression of the reference's scan abstraction
(`src/cl_ops/scan/clo_scan_abstract.c:74-362`, `.in.h:41-162`):

  - named implementation registry (`clo_scan_abstract.c:85-89`)
  - per-object specialization on (elem type, sum type) — the reference splices
    `-D CLO_SCAN_ELEM_TYPE=... -D CLO_SCAN_SUM_TYPE=...` compiler flags
    (`clo_scan_abstract.c:122-125`); here specialization is jit static args
  - `scan_with_device_data` / `scan_with_host_data` entry points
    (`clo_scan_abstract.in.h:113-140`), where "device data" is a jax.Array and
    "host data" is a numpy array (H2D/D2H transfers are the device_put /
    np.asarray boundary)
  - kernel introspection: num kernels / kernel names / local-mem usage
    (`clo_scan_abstract.in.h:144-162`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from cl_ops_tpu.core.dtypes import canonicalize, default_sum_dtype
from cl_ops_tpu.core.errors import BadArgsError
from cl_ops_tpu.core.registry import Registry, parse_options
from cl_ops_tpu.ops.scan import kernels


@dataclasses.dataclass(frozen=True)
class ScanImplDef:
    """Vtable analog of CloScanImplDef (clo_scan_abstract.in.h:41-103)."""

    name: str
    # (elem_dtype, sum_dtype, options) -> jitted fn(x, exclusive) -> scanned
    make_fn: Callable[..., Callable]
    kernel_names: tuple[str, ...]
    # On-chip bytes one program of a kernel holds for a given problem size
    # and (elem, sum) dtypes (the reference's localmem usage).
    localmem_usage: Callable[[str, int, Any, Any, dict], int]


scan_impls: Registry[ScanImplDef] = Registry("scan")


class Scan:
    """A dtype-specialized scanner (analog of `struct clo_scan`)."""

    def __init__(self, impl: ScanImplDef, elem_dtype, sum_dtype,
                 options: dict[str, str]):
        self._impl = impl
        self.elem_dtype = canonicalize(elem_dtype)
        self.sum_dtype = (canonicalize(sum_dtype) if sum_dtype is not None
                          else default_sum_dtype(self.elem_dtype))
        self._options = options
        self._fn = impl.make_fn(self.elem_dtype, self.sum_dtype, options)

    # -- introspection (parity: clo_scan_abstract.in.h:144-170) -------------
    @property
    def name(self) -> str:
        return self._impl.name

    @property
    def num_kernels(self) -> int:
        return len(self._impl.kernel_names)

    def kernel_name(self, i: int) -> str:
        return self._impl.kernel_names[i]

    def localmem_usage(self, kernel_name: str, numel: int) -> int:
        """On-chip bytes one program of a kernel holds (parity:
        clo_scan_get_localmem_usage, clo_scan_abstract.in.h:158-162)."""
        return self._impl.localmem_usage(kernel_name, numel, self.elem_dtype,
                                         self.sum_dtype, self._options)

    # -- entry points --------------------------------------------------------
    def scan_with_device_data(self, x: jax.Array, *,
                              exclusive: bool = True) -> jax.Array:
        """Scan a device array (parity: clo_scan_with_device_data)."""
        if x.ndim != 1:
            raise BadArgsError(f"scan expects 1-D input, got shape {x.shape}")
        if jnp.dtype(x.dtype) != self.elem_dtype:
            raise BadArgsError(
                f"input dtype {x.dtype} != specialized elem dtype "
                f"{self.elem_dtype}")
        return self._fn(x, exclusive)

    def scan_with_host_data(self, x, *, exclusive: bool = True) -> np.ndarray:
        """Host round trip: H2D, scan, D2H (parity: clo_scan_with_host_data,
        clo_scan_abstract.c:255-362)."""
        dev = jax.device_put(np.asarray(x, self.elem_dtype))
        out = self.scan_with_device_data(dev, exclusive=exclusive)
        return np.asarray(jax.block_until_ready(out))

    __call__ = scan_with_device_data


def scan_new(name: str = "blelloch",
             options: str | dict[str, Any] | None = None,
             elem_dtype="uint", sum_dtype=None) -> Scan:
    """Create a scanner by name (parity: clo_scan_new, clo_scan_abstract.c:74).

    Args:
      name: implementation name ("blelloch" — 3-phase scan: XLA block
        sums + tiny cumsum + one base-fed Triton block-scan kernel,
        mirroring the reference's 3-kernel structure; "xla" — XLA's
        cumsum).
      options: reference-style option string or dict ("block=4096",
        "num_warps=4" for blelloch).
      elem_dtype: input element type (OpenCL-style name or dtype).
      sum_dtype: accumulator/output type; defaults to the widening rule
        (uint -> ulong etc., like clo_scan_bench's defaults).
    """
    impl = scan_impls.get(name)()
    return Scan(impl, elem_dtype, sum_dtype, parse_options(options))


# --- blelloch: three phases, the third a Triton kernel ----------------------

def _blelloch_make_fn(elem_dtype, sum_dtype, options):
    block = int(options.get("block", kernels.BLOCK))
    num_warps = int(options.get("num_warps", kernels.NUM_WARPS))

    def fn(x, exclusive):
        return kernels.scan_1d(x, sum_dtype=sum_dtype, exclusive=exclusive,
                               block=block, num_warps=num_warps)
    return fn


def _blelloch_localmem(kernel_name, numel, elem_dtype, sum_dtype, options):
    if kernel_name != "block_scan_base_add":
        return 0  # XLA phases: no blocks of our choosing
    # one program holds its block of inputs and of running sums
    block = min(int(options.get("block", kernels.BLOCK)), max(numel, 1))
    return block * (jnp.dtype(elem_dtype).itemsize
                    + jnp.dtype(kernels._acc_dtype(sum_dtype)).itemsize)


# Introspection mirrors the reference's 3-kernel structure
# (workgroupScan / workgroupSumsScan / addWorkgroupSums,
# clo_scan_blelloch.cl:49-211): phases 1-2 are XLA here, phase 3 is the
# Triton kernel that fuses the block scan with the base add.
scan_impls.register("blelloch")(lambda: ScanImplDef(
    name="blelloch",
    make_fn=_blelloch_make_fn,
    kernel_names=("block_sums", "block_sums_scan", "block_scan_base_add"),
    localmem_usage=_blelloch_localmem,
))


# --- xla: jnp.cumsum (XLA's own scan; the oracle) ----------------------------

def _xla_make_fn(elem_dtype, sum_dtype, options):
    @jax.jit
    def inclusive(x):
        return jnp.cumsum(x.astype(sum_dtype))

    @jax.jit
    def exclusive_(x):
        inc = jnp.cumsum(x.astype(sum_dtype))
        return inc - x.astype(sum_dtype)

    def fn(x, exclusive):
        return exclusive_(x) if exclusive else inclusive(x)
    return fn


scan_impls.register("xla")(lambda: ScanImplDef(
    name="xla",
    make_fn=_xla_make_fn,
    kernel_names=("cumsum",),
    localmem_usage=lambda k, n, e, s, o: 0,
))


def scan_names() -> list[str]:
    return scan_impls.names()
