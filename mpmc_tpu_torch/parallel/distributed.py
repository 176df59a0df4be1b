"""Multi-process initialization (port of ``mpmc_tpu/parallel/distributed.py``).

One process per GPU, PyTorch's idiom: ``torchrun --nproc-per-node N -m
mpmc_tpu_torch.cli.main train ...`` starts N processes and hands each its
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; :func:`initialize` joins them into one
``torch.distributed`` world, over NCCL on the card and gloo on the CPU.
Without a launched world it does nothing and the run is single-process.
A world that fails to form raises: no run carries on alone in its place.

Rank 0 alone writes the run's files (TSVs, ``run_meta.json``, vocab
files, metrics, checkpoints); :func:`is_writer`, :func:`rank0_first` and
:func:`on_rank0` order the ranks around what they write.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from typing import Callable, Iterator, Optional, TypeVar

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

T = TypeVar("T")

# Long enough for rank 0 alone to run a pretraining stage while the
# others wait at a barrier; a hung collective still ends the run.
TIMEOUT = datetime.timedelta(minutes=60)


def launched_world() -> Optional[dict]:
    """The world ``torchrun`` (or ``dist_worker.launch_processes``)
    launched this process into: ``{"rank", "world_size", "local_rank",
    "addr", "port"}``, or None outside one.  ``MPMC_NUM_PROCESSES`` and
    ``MPMC_PROCESS_ID`` stand in for ``WORLD_SIZE`` and ``RANK``, as the
    JAX package reads them."""
    env = os.environ
    size = env.get("WORLD_SIZE", env.get("MPMC_NUM_PROCESSES"))
    if size is None:
        return None
    rank = env.get("RANK", env.get("MPMC_PROCESS_ID"))
    if rank is None:
        raise RuntimeError(f"a world of {size} processes was launched, but "
                           "this process has no RANK (or MPMC_PROCESS_ID)")
    return {"rank": int(rank), "world_size": int(size),
            "local_rank": int(env.get("LOCAL_RANK", rank)),
            "addr": env.get("MASTER_ADDR", "127.0.0.1"),
            "port": int(env.get("MASTER_PORT", "29500"))}


def initialize(device: str = "cuda") -> bool:
    """Join the launched world (:func:`launched_world`) with NCCL when
    ``device`` is a CUDA device, gloo on the CPU; on CUDA the process
    takes ``cuda:LOCAL_RANK``.  Returns True in a launched world (also of
    one process), False outside one.  Any failure raises."""
    if dist.is_initialized():
        return True
    world = launched_world()
    if world is None:
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(world["local_rank"])
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=f"tcp://{world['addr']}:{world['port']}",
        world_size=world["world_size"], rank=world["rank"],
        timeout=TIMEOUT,
        device_id=(torch.device("cuda", world["local_rank"]) if cuda
                   else None))
    log.info("torch.distributed initialized: rank %d/%d over %s",
             dist.get_rank(), dist.get_world_size(), dist.get_backend())
    return True


def device_for(device: str) -> torch.device:
    """``device``, or in a launched world on CUDA this process's GPU."""
    d = torch.device(device)
    if d.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return d


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """True on the process that writes the run's files: rank 0, or the
    only process."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


@contextlib.contextmanager
def rank0_first() -> Iterator[None]:
    """Rank 0 runs the block first (and writes the caches it fills), the
    others after it, reading them."""
    if rank() != 0:
        barrier()
    yield
    if rank() == 0:
        barrier()


def on_rank0(fn: Callable[[], T]) -> Optional[T]:
    """``fn()`` on rank 0 alone while the others wait; returns its value
    on rank 0 and None elsewhere."""
    out = fn() if rank() == 0 else None
    barrier()
    return out


def host_local_batch_slice(global_batch: int) -> slice:
    """The slice of the global batch this process feeds (per-process
    sharding of the input pipeline)."""
    per = global_batch // max(world_size(), 1)
    start = rank() * per
    return slice(start, start + per)
