"""Mesh + collective layer: multi-chip operator scaling.

No referent in the reference library (single-device only, SURVEY.md §2.3);
this layer realizes the BASELINE.json north star: row-partitioned tables over
a device mesh, per-device operators wrapped in shard_map, XLA collectives
(all_gather/psum/all_to_all, NCCL on GPUs) as the exchange backend.
"""

from cl_ops_tpu.parallel.mesh import (DATA_AXIS, make_mesh, replicated,
                                      row_sharding)
from cl_ops_tpu.parallel.aggregate import (dist_group_aggregate,
                                           dist_group_aggregate_cols)
from cl_ops_tpu.parallel.join import (dist_hash_join,
                                      dist_hash_join_expand)
from cl_ops_tpu.parallel.scan import dist_scan, dist_segmented_scan
from cl_ops_tpu.parallel.shuffle import partition_exchange
from cl_ops_tpu.parallel.splitters import (dist_sort_sample,
                                           keyed_exchange_once,
                                           keyed_exchange_replan,
                                           plan_splitters,
                                           range_partition_exchange)
from cl_ops_tpu.parallel.sort import dist_sort, dist_sort_i32_cols
from cl_ops_tpu.parallel.topk import dist_distinct, dist_top_k
from cl_ops_tpu.parallel.window import dist_window_cols, dist_window_scan

__all__ = ["DATA_AXIS", "dist_distinct", "dist_group_aggregate",
           "dist_group_aggregate_cols", "dist_hash_join",
           "dist_hash_join_expand",
           "dist_scan", "dist_segmented_scan", "dist_sort",
           "dist_sort_i32_cols", "dist_sort_sample", "dist_top_k",
           "dist_window_cols", "dist_window_scan",
           "keyed_exchange_once", "keyed_exchange_replan", "make_mesh",
           "partition_exchange", "plan_splitters",
           "range_partition_exchange", "replicated", "row_sharding"]
