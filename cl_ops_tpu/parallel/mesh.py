"""Device-mesh helpers.

The reference is strictly single-device (`SURVEY.md` §2.3; e.g.
`clo_sort_abstract.c:333-341` picks device 0 of one context). The mesh layer
is therefore new-framework territory (BASELINE.json north star): operators
scale by hash/range-partitioning rows over a 1-D "data" mesh axis, with XLA
collectives (NCCL over NVLink on GPUs) replacing the reference's absent
distributed backend.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def row_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Rows partitioned over the mesh axis — the DP-for-tables layout."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_sharded(a, mesh: Mesh, axis: str = DATA_AXIS):
    """device_put onto the row sharding, passing through arrays already
    laid out that way.

    The passthrough is what makes the distributed operators multi-process
    capable: a global jax.Array spanning several processes cannot be
    re-device_put from one process's host data, but arrays built with
    jax.make_array_from_process_local_data (parallel/multiproc.py) already
    carry the right sharding and flow straight through.
    """
    sharding = NamedSharding(mesh, P(axis))
    if isinstance(a, jax.Array) and not isinstance(a, jax.core.Tracer):
        try:
            if a.sharding.is_equivalent_to(sharding, a.ndim):
                return a
        except (AttributeError, ValueError):
            pass
    return jax.device_put(a, sharding)


import functools


@functools.lru_cache(maxsize=None)
def mesh_program(body, mesh: Mesh, in_specs, out_specs, **static):
    """jit(shard_map(body)) with `static` bound as keyword arguments.

    Built once per (body, mesh, specs, static values): jax.jit caches
    compiled code by function object, so an operator that wrapped a fresh
    closure on every call would re-trace and re-lower every call. Bodies
    are module-level functions; everything shape- or plan-dependent they
    need arrives through hashable `static` values.
    """
    from jax import shard_map
    fn = functools.partial(body, **static) if static else body
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


@functools.lru_cache(maxsize=None)
def replicated_program(body, mesh: Mesh, **static):
    """jit(body) with a replicated output (readable from every process of
    a multi-process mesh), built once per (body, mesh, static values)."""
    fn = functools.partial(body, **static) if static else body
    return jax.jit(fn, out_shardings=NamedSharding(mesh, P()))


@functools.lru_cache(maxsize=None)
def _iota_fn(n: int, mesh: Mesh, axis: str, dtype):
    import jax.numpy as jnp
    return jax.jit(lambda: jnp.arange(n, dtype=dtype),
                   out_shardings=NamedSharding(mesh, P(axis)))


def iota_sharded(n: int, mesh: Mesh, axis: str = DATA_AXIS,
                 dtype=np.int32):
    """arange(n) materialized directly in the row sharding.

    jnp.arange would land process-local; producing it from a no-input jit
    with out_shardings works identically in single- and multi-process
    meshes (every process runs the same program). The jitted callables
    cache per (n, mesh, axis, dtype) — a fresh jax.jit per call would
    retrace (and remote-recompile) every time.
    """
    return _iota_fn(n, mesh, axis, np.dtype(dtype).name)()


@functools.lru_cache(maxsize=None)
def _repl_sum_fn(mesh: Mesh):
    import jax.numpy as jnp
    return jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))


def replicated_sum_int(x, mesh: Mesh) -> int:
    """Host int of sum(x) — safe for multi-process global arrays.

    jax.device_get on a non-fully-addressable array raises; summing to a
    REPLICATED scalar gives every process an addressable copy to read.
    The jitted reducer caches per mesh.
    """
    tot = _repl_sum_fn(mesh)(x)
    return int(np.asarray(tot.addressable_shards[0].data))
