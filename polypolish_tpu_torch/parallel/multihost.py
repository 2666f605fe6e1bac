"""Multi-process initialisation over ``torch.distributed`` (counterpart
of polypolish_tpu/parallel/multihost.py, which starts
``jax.distributed``).

The port's collectives run on host tensors over the gloo backend: the
pod merges host arrays (pipeline/pod_distributed.py), and gloo lets
several ranks share one card, where NCCL needs a card per rank.

On single-process runs this module is a no-op.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group at ``coordinator_address`` (host:port;
    rank 0 listens there) as rank ``process_id`` of ``num_processes``.

    Arguments default to the JAX package's environment variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), so
    one launcher drives both packages.  Returns True once the group is
    up, False when neither an address nor a process count is given.
    The JAX package also auto-detects a TPU pod's workers; a GPU host
    advertises no such list, so there is nothing to detect here."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a process group needs a coordinator address, the process "
            "count and this process's id; got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}"
        )
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(n_pos: Optional[int] = None, device="cuda"):
    """(data, pos) grid over every device a process of the job can see.
    A torch process drives its own devices only, so this is the
    process-local grid over ``device`` (visible_devices)."""
    from polypolish_tpu_torch.parallel.mesh import make_mesh, visible_devices

    return make_mesh(n_pos=n_pos, devices=visible_devices(device))
