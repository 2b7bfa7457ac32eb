"""Process-group initialisation across processes and hosts.

Counterpart of ``commpy_tpu/parallel/distributed.py``.  JAX runs one
process per host over many devices; PyTorch runs one process (a rank) per
device, so a sweep over N GPUs is N processes, started by ``torchrun`` or
by the caller, each calling :func:`initialize` and then the same sharded
code (SPMD):

    from commpy_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()          # reads torchrun's RANK, WORLD_SIZE
    mesh = make_mesh()                # one rank per GPU, NCCL
    res = montecarlo_ber(..., mesh=mesh,
                         frames_per_round=N * mesh.size())

Keep the rounds large so the stopping decision (one all-reduce a round)
is rare next to the decoding.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "process_info"]


def _backend(device_type: str) -> str:
    # NCCL carries the CUDA tensors and gloo the host tensors (the
    # checkpoint state broadcast, the CPU tests)
    return "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"


def initialize(init_method=None, world_size=None, rank=None,
               device="cuda"):
    """Initialise the default process group (idempotent).

    ``init_method``, ``world_size`` and ``rank`` as
    ``torch.distributed.init_process_group`` takes them.  Left out, they
    come from torchrun's ``RANK`` and ``WORLD_SIZE`` (``env://``); with
    neither, the group is this process alone (world size 1), met through
    a ``file://`` store in a fresh temporary directory: no network and no
    port to clash.  ``device='cuda'`` adds NCCL for CUDA tensors and
    selects the GPU ``LOCAL_RANK`` names (else ``rank`` modulo the GPUs
    this process sees); ``'cpu'`` runs gloo alone.
    """
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run on the host")
    if init_method is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            rank = int(os.environ["RANK"]) if rank is None else rank
            world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                          else world_size)
        else:
            store = os.path.join(tempfile.mkdtemp(prefix="commpy_pg_"),
                                 "store")
            init_method = f"file://{store}"
            world_size, rank = 1, 0
    if world_size is None or rank is None:
        raise ValueError("an explicit init_method needs world_size and rank")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(_backend(dev.type), init_method=init_method,
                            world_size=int(world_size), rank=int(rank))


def is_initialized() -> bool:
    return dist.is_initialized()


def process_info():
    """(rank, world size, GPUs this process sees, devices in the world).

    One rank drives one device, so the world's device count is its size;
    without a process group this is a world of one.
    """
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    return rank, world, torch.cuda.device_count(), world
