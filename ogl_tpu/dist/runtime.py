"""Multi-process / multi-host runtime — the role of the reference's MPI
initialisation and communicator plumbing (ExecutorHandler.H:115-179:
MPI_COMM_WORLD wrapping, GPU-aware-MPI detection, forceHostBuffer).

The transport questions disappear (XLA emits NCCL collectives from
shardings); what remains is process bootstrap and data staging:

  init_distributed()  -> jax.distributed.initialize from env/args (the
                         MPI_Init analogue; no-op single-process)
  global_mesh()       -> 1-D Mesh over every device of every process
  stage_stack(...)    -> build the (P, ...) parts-stacked global array from
                         per-process host shards WITHOUT materialising the
                         global array on any single host (the multi-host
                         replacement for jnp.asarray on a full stack)

A multi-host run is then:
  ogl_tpu.dist.runtime.init_distributed()
  mesh = ogl_tpu.dist.runtime.global_mesh()
  ... DistAssembler on each process's OWN ranks, stage_stack the stacks,
  dist_solve over the mesh.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init_distributed", "global_mesh", "stage_stack", "stage_tree",
           "broadcast_scalars", "allgather_ragged"]


def allgather_ragged(arrays: list[np.ndarray]) -> list[list[np.ndarray]]:
    """All-gather variable-length 1-D host arrays across processes: each
    process contributes a LIST of arrays (one per locally-owned rank) and
    receives every process's lists concatenated in process order.

    This is the metadata exchange a per-rank construction needs (sizes,
    interface face lists — all surface-sized): the reference gets it
    implicitly because MPI ranks exchange through Pstream; here the
    equivalent is two fixed-shape process_allgathers (lengths, then padded
    payload).  Single-process: identity."""
    if jax.process_count() <= 1:
        return [arrays]
    from jax.experimental import multihost_utils

    k = len(arrays)
    counts = multihost_utils.process_allgather(np.asarray([k]))
    if not (np.asarray(counts) == k).all():
        raise ValueError(
            f"every process must contribute the same number of arrays; "
            f"got {np.asarray(counts).ravel().tolist()}")
    lens = np.asarray([len(a) for a in arrays], np.int64)
    all_lens = np.asarray(multihost_utils.process_allgather(lens))
    lmax = max(int(all_lens.max()), 1)
    pad = np.zeros((k, lmax), np.float64)
    for i, a in enumerate(arrays):
        pad[i, : len(a)] = np.asarray(a, np.float64)
    data = np.asarray(multihost_utils.process_allgather(pad))
    out = []
    for p in range(data.shape[0]):
        out.append([data[p, i, : int(all_lens[p, i])] for i in range(k)])
    return out


def broadcast_scalars(*values: float) -> tuple[float, ...]:
    """Process-0's values on every process (the reference's MPI broadcast of
    the measured residual-eval cost ratio, lduLduBase.H:291-293).

    Host wall-clock measurements differ per process; anything derived from
    them that feeds a REPLICATED traced argument (StoppingParams under
    adaptMinIter) must be agreed on first — otherwise each process jits a
    different minIter/frequency for a value jax assumes identical.
    No-op single-process."""
    if jax.process_count() <= 1:
        return values
    from jax.experimental import multihost_utils

    out = multihost_utils.broadcast_one_to_all(
        np.asarray(values, np.float64))
    return tuple(float(v) for v in np.asarray(out))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialise jax.distributed (multi-host).  Args default to the
    standard env variables (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID).
    Returns True if a multi-process runtime was initialised, False when
    single-process (nothing to do — the reference aborts without MPI,
    lduLduBase.H:321-329; we support serial by design)."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_str = os.environ.get("JAX_NUM_PROCESSES")
    num_processes = num_processes if num_processes is not None else (
        int(num_str) if num_str else None)
    pid_str = os.environ.get("JAX_PROCESS_ID")
    process_id = process_id if process_id is not None else (
        int(pid_str) if pid_str else None)
    if coordinator_address is None and num_processes is None:
        # only attempt when explicitly requested: an unconfigured
        # initialize() would hang single-host runs
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def global_mesh(axis: str = "x") -> Mesh:
    """1-D mesh over all devices of all processes (device order = jax's
    global enumeration, so shard i of a parts-stacked array lands on global
    device i)."""
    return Mesh(np.array(jax.devices()), (axis,))


def stage_stack(local_shards, mesh: Mesh, axis: str = "x"):
    """Assemble a parts-stacked global array from per-process data.

    local_shards: list of this process's shard arrays (leading axis absent),
    one per local device, in `mesh`-order.  Each process passes only ITS
    shards; the result is a global jax.Array of shape (P, *shard_shape)
    sharded one part per device — no host ever holds the full stack
    (the multi-host analogue of the reference's per-rank device upload,
    Array.H:58-88).
    """
    sharding = NamedSharding(mesh, P(axis))
    local_devices = [d for d in mesh.devices.ravel() if d.process_index == jax.process_index()]
    assert len(local_shards) == len(local_devices), (
        f"process {jax.process_index()} owns {len(local_devices)} mesh devices "
        f"but got {len(local_shards)} shards"
    )
    shard_shape = np.asarray(local_shards[0]).shape
    global_shape = (int(np.prod(mesh.devices.shape)),) + shard_shape
    buffers = [
        jax.device_put(np.asarray(s)[None], d)
        for s, d in zip(local_shards, local_devices)
    ]
    return jax.make_array_from_single_device_arrays(global_shape, sharding, buffers)


def stage_tree(tree, mesh: Mesh, axis: str = "x"):
    """Stage every parts-stacked array leaf of a pytree (leading dim == the
    mesh size, e.g. a DistMatrix's local/halo stacks or a b/x stack) into a
    global sharded array via `stage_stack`; other leaves pass through.
    Each process contributes the slices belonging to ITS mesh devices —
    the bulk data never exists globally on one host."""
    from ogl_tpu.dist.partition import HaloPlan

    n_parts = int(np.prod(mesh.devices.shape))
    mine = [i for i, d in enumerate(mesh.devices.ravel())
            if d.process_index == jax.process_index()]

    def stage(leaf):
        if isinstance(leaf, HaloPlan):
            # the halo plan must stay a REPLICATED constant: shard bodies
            # index its (P, S) tables by axis_index, so sharding them
            # would break halo exchange
            return leaf
        arr = np.asarray(leaf) if not hasattr(leaf, "ndim") else leaf
        if getattr(arr, "ndim", 0) >= 1 and arr.shape[0] == n_parts:
            host = np.asarray(jax.device_get(arr))
            return stage_stack([host[i] for i in mine], mesh, axis)
        return leaf

    return jax.tree_util.tree_map(
        stage, tree, is_leaf=lambda x: isinstance(x, HaloPlan))
