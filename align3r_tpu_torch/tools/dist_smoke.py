"""Multi-process smoke of parallel/mesh.py (port of tool/dist_smoke.py).

Each process joins the group the environment describes
(``maybe_init_distributed``), gives rank + 1 to an all_reduce, and checks
the sum over every process and that ``process_slice`` follows the live rank.
It prints ``DIST_SMOKE_OK pid=<rank> nproc=<world> psum=<sum> slice=<list>``.

    ALIGN3R_COORDINATOR=localhost:<port> ALIGN3R_NUM_PROCESSES=2 \\
        ALIGN3R_PROCESS_ID=<0|1> python -m align3r_tpu_torch.tools.dist_smoke
    torchrun --nproc_per_node 2 -m align3r_tpu_torch.tools.dist_smoke

The all_reduce runs on the card with NCCL (one card a process) and with
gloo where there is no CUDA or the host's ranks outnumber its cards.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from align3r_tpu_torch.parallel.mesh import (local_device_index, maybe_init_distributed,
                                             process_slice, rank, world_size)


def main() -> int:
    if not maybe_init_distributed():
        raise SystemExit("maybe_init_distributed returned False: set ALIGN3R_COORDINATOR, "
                         "ALIGN3R_NUM_PROCESSES and ALIGN3R_PROCESS_ID, or run under torchrun")
    try:
        n, pid = world_size(), rank()
        if "ALIGN3R_NUM_PROCESSES" in os.environ:
            assert n == int(os.environ["ALIGN3R_NUM_PROCESSES"]), n
            assert pid == int(os.environ["ALIGN3R_PROCESS_ID"]), pid
        dev = (torch.device("cuda", local_device_index())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        x = torch.full((1,), float(pid + 1), device=dev)
        dist.all_reduce(x)
        total = float(x.item())
        expect = float(n * (n + 1) // 2)
        assert total == expect, (total, expect)
        sl = process_slice(list(range(5)))
        assert sl == list(range(5))[pid::n], sl
        print(f"DIST_SMOKE_OK pid={pid} nproc={n} psum={total} slice={sl}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
