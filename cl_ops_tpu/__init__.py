"""cl_ops_tpu — data-parallel primitives and query execution in JAX.

A JAX/XLA/Pallas framework with the capabilities of the reference OpenCL
library `nunofachada/cl_ops` (sorting, prefix-sum scan, per-stream PRNG),
extended into a vectorized query-execution engine (filter, hash aggregate,
hash join) that scales over device meshes. It runs on NVIDIA GPUs (the one
hand kernel compiles through Triton) and, for the tests, on the CPU.

Layer map (new framework):
  core/     — dtype registry, op registries, errors        (ref L1: common/)
  utils/    — bit/worksize helpers, platform detection      (ref L1)
  ops/      — rng/, scan/, sort/, exec/ operator families   (ref L2+L3)
  native/   — C++ CPU oracle library (ctypes)               (ref: native host layer)
  parallel/ — mesh + collective layer (shard_map, ppermute) (no referent; north star)
  models/   — flagship query pipelines                      (north star)
  bench/    — measurement + verification harness            (ref L4: benchmarks/)

Quick start:
  from cl_ops_tpu.ops.sort import sort_new
  sorter = sort_new("abitonic")                # Pallas fused bitonic
  out = sorter.sort_with_host_data(np_array)   # H2D, sort, D2H

  from cl_ops_tpu.ops.scan import scan_new
  scan = scan_new("blelloch")                  # single-pass grid-carry scan
  sums = scan.scan_with_host_data(np_uint32)   # exclusive, uint -> ulong

  from cl_ops_tpu.ops.rng import rng_new
  rng = rng_new("threefry", "dev_gid", num_streams=1 << 18, main_seed=42)
  draws = rng.generate(10)                     # (10, 262144) uint32
"""

from cl_ops_tpu.core import dtypes, errors, registry
from cl_ops_tpu.defer import DeferredOverflowError, verify_deferred
from cl_ops_tpu.utils import bits

__version__ = "0.2.0"

__all__ = ["DeferredOverflowError", "dtypes", "errors", "registry", "bits",
           "verify_deferred", "__version__"]
