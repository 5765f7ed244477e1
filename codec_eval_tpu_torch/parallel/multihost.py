"""Multi-process corpus sharding over ``torch.distributed``.

Port of ``codec_eval_tpu/parallel/multihost.py``: one process per device
(or per host), a global mesh whose batch axis spans every process, the
corpus partitioned over the processes, and the results all-gathered so that
every process returns the whole corpus's scores.

The process group uses the **gloo** backend.  The steps exchange only
host-side results (per-pair scores and packed rate histograms, tens of
numbers per pair, already fetched from the device), so no device
collective is needed, and gloo serves one card per process and two
processes that share one card alike (NCCL refuses two ranks on one card).

Launch with ``torchrun --nproc-per-node=N`` and call
``initialize_distributed()`` (it reads torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``), or pass the coordinator's
``host:port``, the process count and this process's index explicitly.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, _split_local, make_mesh

__all__ = [
    "initialize_distributed",
    "global_batch_mesh",
    "partition_corpus",
    "host_local_batch_to_global",
]

#: How long joining the group, and each collective, may wait for the
#: other processes before it fails.
TIMEOUT = datetime.timedelta(minutes=5)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the gloo process group (idempotent: a no-op when one exists).

    With arguments, the group meets at ``tcp://<coordinator_address>``
    (``host:port``); with none, at torchrun's ``env://``.  With neither, it
    raises.  Joining and every collective time out after ``TIMEOUT``.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    given = (coordinator_address, num_processes, process_id)
    if all(v is not None for v in given):
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                  rank=int(process_id))
    elif any(v is not None for v in given):
        raise ValueError("pass coordinator_address, num_processes and process_id together")
    elif all(k in os.environ for k in _ENV):
        kw = dict(init_method="env://")
    else:
        raise RuntimeError(
            "initialize_distributed: no coordinator given and no torchrun environment; set "
            + ", ".join(_ENV) + " (torchrun does) or pass coordinator_address, "
            "num_processes and process_id"
        )
    dist.init_process_group("gloo", timeout=TIMEOUT, **kw)


def global_batch_mesh(n_space: int = 1, devices=None) -> Mesh:
    """A (batch, space) mesh whose batch axis spans every process.

    Each process holds its own ``devices``: by default the one CUDA device
    ``cuda:(LOCAL_RANK % device_count)`` (torchrun's convention; the group
    rank where ``LOCAL_RANK`` is unset), so two processes on one card both
    take ``cuda:0``.  Its local grid is ``(len(devices) // n_space,
    n_space)``: the space axis lies inside a process, as JAX's mesh has it
    when each host's device count divides by ``n_space``.
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("global_batch_mesh needs a process group: call "
                           "initialize_distributed first")
    rank, world = dist.get_rank(), dist.get_world_size()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_batch_mesh: CUDA is not available; pass devices= "
                               "for the host")
        local = int(os.environ.get("LOCAL_RANK", rank))
        devices = [torch.device("cuda", local % torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) % n_space:
        raise ValueError(f"{len(devices)} local devices do not split over n_space={n_space}")
    local_mesh = make_mesh(n_batch=len(devices) // n_space, n_space=n_space, devices=devices)
    return Mesh(local_mesh.devices, process_index=rank, process_count=world)


def partition_corpus(
    items: Sequence, process_id: Optional[int] = None, num_processes: Optional[int] = None,
) -> List:
    """This process's strided share of the corpus (deterministic, balanced).

    Stride partitioning keeps the processes' work balanced when image sizes
    cluster by position in the corpus listing.  Without a process group
    this is process 0 of 1.
    """
    import torch.distributed as dist

    grouped = dist.is_initialized()
    pid = (dist.get_rank() if grouped else 0) if process_id is None else process_id
    n = (dist.get_world_size() if grouped else 1) if num_processes is None else num_processes
    return list(items[pid::n])


def host_local_batch_to_global(mesh: Mesh, local_batch: np.ndarray) -> list:
    """This process's share of the global batch, split over its local
    batch devices: the shards that the mesh's steps take.

    The global batch is the concatenation of every process's local batch
    in process order (standard multi-process data-parallel feeding), and
    every step's results cover it all.
    """
    return _split_local(mesh, np.asarray(local_batch), spatial=False)
