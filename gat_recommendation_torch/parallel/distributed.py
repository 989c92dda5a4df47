"""Multi-process training: the process group, and what each process feeds.

One process drives one GPU; ``initialize`` joins this process to the group
when a multi-process launch is detected:

* the JAX package's variables (``JAX_COORDINATOR_ADDRESS`` or
  ``COORDINATOR_ADDRESS`` = host:port, ``NUM_PROCESSES``, ``PROCESS_ID``),
  or explicit arguments;
* torchrun's (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``).

The backend follows the caller's device: ``nccl`` for ``cuda``, ``gloo`` for
``cpu``, never one for the other. A detected launch that fails to initialise
raises (the JAX package warns and goes on as one process; a port that trained
alone while its peers waited would hang them). ``single_process_group`` makes
a group of one on a free local port, for a 1x1 mesh without a launcher.

Feeding: ``iterate_batches``'s schedule is a pure function of (dataset,
seed), so every process computes the same global batches and process p
assembles only its rows (``host_shard``); the sharded steps rebuild the
replicated GradIndex from the global meta's ids. What the JAX package's
``make_global_batch`` and ``allgather_pytree`` do becomes: the local rows go
to this rank's device (``data/batching.to_device``), and evaluation outputs
are gathered over the data group (``allgather``) so every process computes
the same metrics and the same early stop; rank 0 alone writes files.
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

# A collective that waits longer than this fails instead of hanging its caller.
TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for {kind}")
    return "nccl" if kind == "cuda" else "gloo"


def _launch() -> tuple[str, int, int, int] | None:
    """(init_method, world size, rank, local rank) of a detected launch."""
    env = os.environ
    coordinator = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
    if coordinator:
        rank = int(env.get("PROCESS_ID", "0"))
        return f"tcp://{coordinator}", int(env.get("NUM_PROCESSES", "1")), rank, int(env.get("LOCAL_RANK", rank))
    if int(env.get("WORLD_SIZE", "1")) > 1 or "MASTER_ADDR" in env:
        # torchrun's rendezvous variables; env:// raises for any that is missing
        rank = int(env.get("RANK", "0"))
        return "env://", int(env.get("WORLD_SIZE", "1")), rank, int(env.get("LOCAL_RANK", rank))
    return None


def _join(init_method: str, world_size: int, rank: int, local_rank: int, device) -> None:
    backend = backend_for(device)
    if backend == "nccl":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"process {rank} (local rank {local_rank}) needs GPU {local_rank}; "
                               f"{torch.cuda.device_count()} GPUs are visible")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank, timeout=TIMEOUT)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> bool:
    """Join the process group of a detected launch (explicit arguments, or
    the variables of the module docstring) on `device`'s backend; True when
    the group is up (already, or now), False when no launch is detected.
    Raises if joining fails."""
    if dist.is_initialized():
        return True
    if coordinator_address is not None:
        rank = 0 if process_id is None else process_id
        launch = (f"tcp://{coordinator_address}", num_processes or 1, rank, rank)
    else:
        launch = _launch()
    if launch is None:
        return False
    _join(*launch, device)
    return True


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now (for a local group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def single_process_group(device="cuda") -> None:
    """A process group of this process alone (a 1x1 mesh without a launcher),
    on 127.0.0.1 and a free port; nothing when a group is up already."""
    if not dist.is_initialized():
        _join(f"tcp://127.0.0.1:{free_port()}", 1, 0, 0, device)


def shutdown() -> None:
    """Leave the process group (every exit path of a multi-process run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns the host's side effects (files, logs of record)."""
    return process_index() == 0


def host_shard(chunk: list, batch_size: int, pindex: int, pcount: int) -> tuple[list, int]:
    """The session indices of one GLOBAL batch (`chunk`, possibly short) that
    land in process `pindex`'s rows ``[pindex * local, (pindex + 1) * local)``,
    and local = batch_size / pcount."""
    if batch_size % pcount:
        raise ValueError(f"global batch size {batch_size} must divide by process count {pcount}")
    local = batch_size // pcount
    return chunk[pindex * local:(pindex + 1) * local], local


def allgather(tensor: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's `tensor` of `group` concatenated on axis 0, as numpy on
    every rank (a copy to the host without a group)."""
    if group is None or dist.get_world_size(group) == 1:
        return tensor.cpu().numpy()
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor, group=group)
    return torch.cat(parts).cpu().numpy()

