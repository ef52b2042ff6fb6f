"""Setting up a world of processes (counterpart of
``empanada_tpu/parallel/multihost.py``).

The JAX package calls ``jax.distributed.initialize``, after which
``jax.devices()`` spans every host.  The port starts one process per card
and joins them into one ``torch.distributed`` world through a TCP
rendezvous at the coordinator (the reference's launcher does the same,
``empanada_napari/multigpu.py``): NCCL between cards, gloo for the CPU.
Every rank then runs the same program on its own card
(``parallel.mesh``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from empanada_tpu_torch.utils import local_rank, resolve_device

__all__ = ["initialize_multihost", "is_multihost", "local_device_slice", "local_rank"]

# how long a collective waits for a rank before the run fails
DEFAULT_TIMEOUT_S = 600


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None,
                         backend: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join this process to the world at ``coordinator_address``
    ("host:port", the rendezvous of rank 0) as rank ``process_id`` of
    ``num_processes``; returns (rank, world size).

    Without a coordinator, torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
    ``WORLD_SIZE``/``RANK`` are read; with neither this is a no-op
    returning (0, 1), as JAX's is for a single process.  A second call
    returns the world that exists.  ``device`` (the entry-point rule:
    None is "cuda") picks the backend unless ``backend`` does: NCCL for a
    card, gloo for the CPU.  With NCCL this process's card becomes
    ``cuda:<local_rank>``, the current device.  A failed rendezvous raises;
    a collective that waits longer than ``timeout_s`` for a rank fails the
    run."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        num_processes = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
        process_id = process_id if process_id is not None else int(os.environ["RANK"])
    if coordinator_address is None:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator_address}: num_processes and process_id "
                         "are required")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a world of {num_processes}")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if backend == "nccl":
        index = dev.index if dev.index is not None else int(
            os.environ.get("LOCAL_RANK", process_id % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dist.get_rank(), dist.get_world_size()


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def local_device_slice():
    """(start, stop) of this process's cards in the world's list of cards,
    one per rank: (rank, rank + 1), or (0, 1) outside a world."""
    r = dist.get_rank() if dist.is_initialized() else 0
    return r, r + 1
