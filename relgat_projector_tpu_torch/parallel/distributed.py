"""Process-group initialization on ``torch.distributed``.

Port of ``relgat_projector_tpu/parallel/distributed.py``. Each rank is one
process driving one device; one call per process, before the trainer is
built:

    from relgat_projector_tpu_torch.parallel import initialize_distributed
    initialize_distributed("host0:29500", num_processes=4, process_id=rank)

The backend follows the device the caller trains on: NCCL for CUDA, gloo for
the CPU. A caller may name the backend instead (gloo lets several ranks share
one card, where NCCL refuses two ranks on one device); nothing here chooses
one from what the machine offers. A process group that is already
initialized is used as it is, as ``jax.distributed.initialize`` is a no-op
the second time.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from relgat_projector_tpu_torch.device import DeviceLike, resolve_device

# The backend of each device type the port trains on.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# How long a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT_S = 600.0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: DeviceLike = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> int:
    """Join the process group; returns this process's rank.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous, or an
    init URL (``tcp://host:port``, ``file://`` of a path no earlier group
    used). One process (``num_processes`` None or 1) needs no group
    and gets rank 0. ``backend`` defaults to the one of ``device``."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        if (num_processes not in (None, world)
                or process_id not in (None, rank)):
            raise ValueError(
                f"the process group is already initialized as rank {rank} of "
                f"{world}, not {process_id} of {num_processes}"
            )
        if backend is not None and dist.get_backend() != backend:
            raise ValueError(
                f"the process group is already initialized on "
                f"{dist.get_backend()}, not {backend}"
            )
        return rank
    if num_processes in (None, 1):
        return 0
    if coordinator_address is None or process_id is None:
        raise ValueError(
            "a process group of several processes needs the coordinator "
            "address, the number of processes and this process's id "
            "(--coordinator-address, --num-processes, --process-id)"
        )
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend or BACKENDS[resolve_device(device).type], init_method=url,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return int(process_id)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def torch_device_of_rank(device: DeviceLike) -> torch.device:
    """The device a rank trains on: on a machine with several cards, rank r
    of a CUDA run takes card ``r % cards`` unless the caller named one."""
    dev = resolve_device(device)
    if (dev.type == "cuda" and dev.index is None and dist.is_initialized()
            and torch.cuda.device_count() > 1):
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev
