"""Process groups and data-parallel helpers (port of
align3r_tpu/parallel/mesh.py).

The JAX package runs data parallelism as one program over a device mesh; the
port runs one process a GPU (``torchrun --nproc_per_node N``, or the
``ALIGN3R_COORDINATOR`` variables below) and reduces across processes with
``torch.distributed`` collectives. Every helper reads the live process group
and treats a run without one as a single process.

Collectives on CUDA tensors: NCCL takes them all; gloo (the CPU backend,
also usable for several ranks sharing one card, which NCCL refuses) takes
only ``broadcast`` and ``all_reduce``. The port therefore gathers with
:func:`all_gather_sum`: each rank writes its rows into zeros and one
``all_reduce`` sums them, exact because every element has one writer.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def maybe_init_distributed() -> bool:
    """Join the process group the environment describes (the reference's
    init_process_group, croco/utils/misc.py:222-243, under JAX's variables):
    ALIGN3R_COORDINATOR (host:port) with ALIGN3R_NUM_PROCESSES and
    ALIGN3R_PROCESS_ID gives a tcp:// rendezvous; ALIGN3R_DIST=1, or
    torchrun's RANK and WORLD_SIZE, gives env:// (torchrun's). The backend
    is NCCL, or gloo where there is no CUDA or where this host's ranks
    outnumber its cards (NCCL refuses two ranks on one card). On NCCL each
    process takes the card LOCAL_RANK (else its rank modulo the cards).
    Without these variables it does nothing and returns False; with a group
    already up it returns True."""
    if dist.is_available() and dist.is_initialized():
        return True
    coord = os.environ.get("ALIGN3R_COORDINATOR")
    auto = (os.environ.get("ALIGN3R_DIST") == "1"
            or ("RANK" in os.environ and "WORLD_SIZE" in os.environ))
    if not coord and not auto:
        return False
    backend = ("nccl" if torch.cuda.is_available()
               and _host_ranks(coord) <= torch.cuda.device_count() else "gloo")
    if coord:
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=int(os.environ["ALIGN3R_NUM_PROCESSES"]),
                                rank=int(os.environ["ALIGN3R_PROCESS_ID"]))
    else:
        dist.init_process_group(backend, init_method="env://")
    if backend == "nccl":
        torch.cuda.set_device(local_device_index())
    return True


def _host_ranks(coord: Optional[str]) -> int:
    """The ranks on this host: torchrun's LOCAL_WORLD_SIZE; else, with a
    coordinator on this host, ALIGN3R_NUM_PROCESSES; else one."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if coord and coord.rsplit(":", 1)[0] in ("localhost", "127.0.0.1"):
        return int(os.environ["ALIGN3R_NUM_PROCESSES"])
    return 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_device_index() -> int:
    """The card of this process: LOCAL_RANK (torchrun), else rank modulo the
    cards of the host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank() % max(torch.cuda.device_count(), 1)


def process_slice(items: Sequence, n_proc: Optional[int] = None,
                  proc_id: Optional[int] = None) -> List:
    """This process's share of a work list, every n-th item (the reference
    pose_test.py:98-112 shards sequences across ranks); n_proc / proc_id
    default to the live world size and rank."""
    n = n_proc if n_proc is not None else world_size()
    i = proc_id if proc_id is not None else rank()
    return list(items)[i::n]


def zero1_shard_dims(shapes: Sequence[Sequence[int]], n: int,
                     min_size: int = 2 ** 16) -> List[Optional[int]]:
    """ZeRO-1's choice for each optimizer-state leaf of `shapes` over n
    ranks (JAX zero1_opt_shardings, mesh.py:66-101): its largest dim
    divisible by n (the first such in order of size, largest first), or None
    (kept whole on every rank) for a leaf under min_size elements or with no
    divisible dim."""
    out = []
    for shape in shapes:
        shape = tuple(shape)
        size = int(np.prod(shape)) if shape else 0
        dim = None
        if size >= min_size:
            dim = next((d for d in sorted(range(len(shape)), key=lambda d: -shape[d])
                        if shape[d] % n == 0), None)
        out.append(dim)
    return out


def all_gather_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks in place (all_reduce) and return it; with each
    element written by one rank and zero on the others, a gather that both
    NCCL and gloo take on CUDA tensors."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t
