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

:func:`make_mesh` lays the ranks out as JAX's ('data', 'model') mesh: a model
group splits one replica of the network over its ranks (tensor parallelism,
parallel/shardings.py), the data groups split the batch.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence

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


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks of `group` (the world by default) in place and
    return it; without a process group, `t` as it is."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """all_reduce_sum: with each element written by one rank and zero on the
    others, a gather that both NCCL and gloo take on CUDA tensors."""
    return all_reduce_sum(t, group)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an n_data x n_model layout of the ranks: its data
    group (the ranks that split the batch, one of each model group) and its
    model group (the ranks that split one replica), as process groups, None
    where the run has no process group; its rank in each."""
    n_data: int
    n_model: int
    data_group: Any
    model_group: Any
    data_rank: int
    model_rank: int


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ranks as JAX's make_mesh lays devices out (mesh.py:44-51,
    ``reshape(n_data, n_model)``): model group d is the n_model consecutive
    ranks d n_model .. (d + 1) n_model - 1, data group j the ranks j, j +
    n_model, ... Every rank creates every group (dist.new_group is
    collective). n_data defaults to the world size over n_model; the layout
    must cover the world. A run with no process group is one rank in both."""
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} data x {n_model} model ranks does not cover "
                         f"the {world} ranks of the run")
    if world == 1:
        return Mesh(1, 1, None, None, 0, 0)
    data = [dist.new_group([d * n_model + j for d in range(n_data)]) for j in range(n_model)]
    model = [dist.new_group(list(range(d * n_model, (d + 1) * n_model))) for d in range(n_data)]
    d, j = divmod(rank(), n_model)
    return Mesh(n_data, n_model, data[j], model[d], d, j)
