"""Device-mesh helpers.

The reference's only parallelism is a single-node work-stealing thread pool
(``include/DedicatedThreadPool.h``).  Here the same work -- kernel-integral
assembly, marker pushing, charge deposition, parameter scans -- distributes
over a ``jax.sharding.Mesh`` with named axes:

  * ``rows``: the operator/marker data axis (rides the device interconnect)
  * ``scan``: embarrassingly-parallel parameter-scan / shift axis
              (multi-host, rides DCN)

Multi-host initialization goes through ``jax.distributed`` (no MPI/NCCL).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_rows: int | None = None, n_scan: int = 1,
              devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n_rows is None:
        n_rows = len(devices) // n_scan
    n = n_rows * n_scan
    dev_array = np.array(devices[:n]).reshape(n_rows, n_scan)
    return Mesh(dev_array, axis_names=("rows", "scan"))


def distributed_init(coordinator: str | None = None, num_processes=None,
                     process_id=None):
    """Multi-host bring-up (jax.distributed; DCN-coordinated)."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("rows"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
