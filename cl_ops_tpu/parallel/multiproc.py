"""Multi-process execution: jax.distributed over N processes.

The north star measures scaling at "1 device, 1 host, N >= 2 hosts"
(BASELINE.md); SURVEY.md §4 asks for multi-host tests via multi-process
simulation on one host. This module is the thin host-topology layer: each
process owns a slice of the devices (its "host"), `jax.distributed` wires
the processes into one runtime, and every `parallel/` operator then runs
unchanged — their collectives cross process boundaries (Gloo on the CPU
simulation, the network between hosts otherwise) exactly as they cross
devices within a process.

Simulation recipe (tests/mp_worker.py, tests/test_multiproc.py): spawn N
python processes with JAX_PLATFORMS=cpu and
--xla_force_host_platform_device_count=D, call `init_process`, and build
global arrays with `from_process_local`. The resulting mesh has N*D
devices; shard_map collectives (psum/all_gather/ppermute/all_to_all) run
across processes.
"""

from __future__ import annotations

import numpy as np

from cl_ops_tpu.parallel.mesh import DATA_AXIS


def init_process(process_id: int, num_processes: int,
                 coordinator: str = "localhost:12655") -> None:
    """Join this process into the distributed runtime.

    Must run before any jax computation.
    """
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = DATA_AXIS):
    """1-D mesh over ALL devices of ALL processes."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def from_process_local(local_rows: np.ndarray, mesh, *,
                       axis: str = DATA_AXIS):
    """Assemble a row-sharded global array from this process's row block.

    Process p contributes rows [p*L, (p+1)*L) of the global array (L =
    len(local_rows), equal on every process). The result flows through
    every parallel/ operator via mesh.put_sharded's passthrough.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P(axis))
    n_procs = jax.process_count()
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_rows),
        global_shape=(local_rows.shape[0] * n_procs,))


def local_rows(garr) -> np.ndarray:
    """This process's rows of a row-sharded global array, in device order."""
    shards = sorted(garr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards])
