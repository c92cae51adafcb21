"""Device mesh construction and batch sharding.

The sampler's parallelism axes are (baseline, chain) — both embarrassingly
parallel (SURVEY.md §2.6). We map their flattened product onto a 1D device
mesh; within a device the batch is a vmap axis. No collectives run inside
the sampling loop; cross-device communication exists only for diagnostics
aggregation (psum over the mesh), mirroring the reference's communication
pattern (object scatter + gather of timing dicts only, SURVEY.md §2.7).
"""
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = BATCH_AXIS) -> Mesh:
    """1D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = BATCH_AXIS) -> NamedSharding:
    """Sharding that splits a leading batch axis across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_batch(n: int, n_shards: int) -> int:
    """Padded batch size divisible by the mesh; padding entries are dummy
    chains whose outputs are dropped on the host."""
    return ((n + n_shards - 1) // n_shards) * n_shards


def shard_batch(tree, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """Place every array in ``tree`` with its leading axis sharded over the
    mesh (arrays must already have a batch-divisible leading axis)."""
    sh = batch_sharding(mesh, axis_name)

    def put(x):
        if x is None:
            return None
        return jax.device_put(x, sh)

    return jax.tree.map(put, tree)


def host_local_to_global(tree, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """Assemble globally-sharded arrays from per-process local blocks
    (``jax.make_array_from_process_local_data``): each process contributes
    its contiguous slice of the leading batch axis. The multi-host
    replacement for the reference's ``comm.scatter``
    (run-hydra-pspec.py:483) — data never leaves the host that loaded it."""
    sh = batch_sharding(mesh, axis_name)

    def put(x):
        if x is None:
            return None
        return jax.make_array_from_process_local_data(sh, np.asarray(x))

    return jax.tree.map(put, tree)


def replicated_to_global(tree, mesh: Mesh):
    """Replicate identical host arrays (every process must hold the same
    values) onto the global mesh."""
    sh = replicated_sharding(mesh)

    def put(x):
        if x is None:
            return None
        return jax.make_array_from_process_local_data(sh, np.asarray(x))

    return jax.tree.map(put, tree)


def global_to_host_local(arr, batch_axis: int = 0):
    """This process's contiguous block of a batch-sharded global array, as
    numpy (assembled from addressable shards in batch order)."""
    shards = sorted(
        arr.addressable_shards,
        key=lambda s: s.index[batch_axis].start or 0,
    )
    seen = set()
    parts = []
    for s in shards:
        start = s.index[batch_axis].start or 0
        if start in seen:
            continue  # replicated copies of the same slice
        seen.add(start)
        parts.append(np.asarray(s.data))
    return np.concatenate(parts, axis=batch_axis)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Multi-host bootstrap: ``jax.distributed.initialize`` (the
    replacement for the reference's MPI_COMM_WORLD setup,
    run-hydra-pspec.py:26-31). No-op for single-process runs."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
