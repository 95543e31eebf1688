"""Multi-process support.

Replacement for the reference's multi-machine mode -- Julia
``addprocs(machine_specs)`` + the node-leader reduce/broadcast tree
(``docs/src/perf.md:3``, ``src/utils.jl:51-64``).  Here multi-machine =
multi-process JAX: every process calls :func:`initialize`, builds the same
global mesh over all devices, and feeds its local rows; the sweep's single
statistics ``psum`` is the only collective (NCCL on GPUs) -- the two-level
tree the reference hand-rolls is what XLA's collective lowering does
automatically.

Typical launch, one process per GPU (same script everywhere; on GPUs the
coordinator, process count and process id are given, not discovered):

    import dpmmsubclusters_tpu as dpmm
    from dpmmsubclusters_tpu.parallel import distributed

    distributed.initialize("host0:12345", num_processes=4, process_id=i,
                           local_device_ids=[i])
    x_local = load_my_shard(jax.process_index())
    result = dpmm.fit_distributed(x_local, alpha=10.0, iters=100)

``local_device_ids`` gives each process its own card while every card stays
visible to the CUDA runtime; on four H100s NCCL then joins the processes
peer to peer over NVLink (``P2P/CUMEM`` in its log).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import jax

from .mesh import DATA_AXIS, make_data_mesh

SHARD_AUTOTUNING_OFF = "--xla_gpu_shard_autotuning=false"


def autotune_per_process(environ=os.environ) -> None:
    """Turn off XLA:GPU's sharded autotuning unless ``XLA_FLAGS`` names it.

    In a multi-process job XLA:GPU splits the autotuning of each program
    among the processes and swaps the results through the coordination
    service.  With one process per H100 that exchange crashed the compiler
    (SIGSEGV in processes 2 and 3 of 4, JAX 0.9.0); each process now
    autotunes its own programs.  XLA reads ``XLA_FLAGS`` when the backend
    starts, so this must run before any device is used.
    """
    flags = environ.get("XLA_FLAGS", "")
    if "xla_gpu_shard_autotuning" not in flags:
        environ["XLA_FLAGS"] = f"{flags} {SHARD_AUTOTUNING_OFF}".strip()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Initialize JAX's multi-process runtime.

    Pass the first three arguments: nothing discovers them on a GPU host
    (counterpart of the user-level ``addprocs`` in the reference's docs).
    ``local_device_ids`` are the cards this process drives (all local
    devices when None).
    """
    autotune_per_process()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_data_mesh():
    """1-D data mesh over every chip of every process."""
    return make_data_mesh()


def shard_points_global(x_local: np.ndarray, mesh, chunk: int):
    """Place per-host rows into one globally-sharded [N_global, D] array.

    Every process passes only ITS rows (like the reference's
    ``DistributedArrays.distribute`` where each worker holds a block,
    ``src/dp-parallel-sampling.jl:42``).  Rows are padded per-process to a
    multiple of (local_device_count * chunk).

    Returns (points, valid, n_global) global jax.Arrays.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    import math

    n_local, d = x_local.shape
    n_dev_local = jax.local_device_count()
    # rows must also block into [N/128, 128] lane-major streams
    mult = n_dev_local * math.lcm(chunk, 128)
    n_local_pad = ((max(n_local, 1) + mult - 1) // mult) * mult

    xp = np.zeros((n_local_pad, d), np.float32)
    xp[:n_local] = x_local
    vp = np.zeros((n_local_pad,), bool)
    vp[:n_local] = True

    sharding = NamedSharding(mesh, P(DATA_AXIS))
    points = jax.make_array_from_process_local_data(sharding, xp)
    valid = jax.make_array_from_process_local_data(
        sharding, vp.reshape(n_local_pad // 128, 128)
    )

    # global count of real rows
    n_global = float(
        jax.device_get(
            jax.jit(
                lambda v: jax.numpy.sum(v.astype(jax.numpy.float32)),
                out_shardings=NamedSharding(mesh, P()),
            )(valid)
        )
    )
    return points, valid, n_global
