"""Device-mesh construction + multi-process runtime setup.

The reference is a single-process CPU system (SURVEY.md §5.8 — no
NCCL/MPI/Gloo anywhere). One process drives every card of a host on a
flat 1-D mesh (``sharded_ba.make_mesh``, ``sharded_pgo.make_mesh``):
the cards are joined all to all, so the mesh follows the algorithm
alone. This module covers runs of several processes:
``jax.distributed.initialize`` for the coordinator and a 2-D mesh whose
rows are processes and whose columns are each process's local devices.
The same code paths run in one process with
`--xla_force_host_platform_device_count=N` virtual devices, which is
how CI exercises them.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

PROC_AXIS = "proc"     # across processes
LOCAL_AXIS = "local"   # a process's own devices


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize the multi-host runtime (host 0 = coordinator).

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    when arguments are omitted; a no-op (returns False) when neither is
    provided — single-process operation needs no coordinator."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return True


def make_mesh_2d(n_hosts: Optional[int] = None,
                 devices=None) -> Mesh:
    """(proc, local) mesh over all devices: rows = processes, columns =
    each process's local devices.

    In a multi-process run ``n_hosts = jax.process_count()`` and each
    row is one process's devices; on a virtual single-process mesh any
    divisor of the device count works (CI uses 2×4 over 8 CPU
    devices)."""
    devs = list(devices if devices is not None else jax.devices())
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    n = len(devs)
    if n % n_hosts != 0:
        raise ValueError(f"{n} devices not divisible by {n_hosts} hosts")
    grid = np.asarray(devs).reshape(n_hosts, n // n_hosts)
    return Mesh(grid, (PROC_AXIS, LOCAL_AXIS))

