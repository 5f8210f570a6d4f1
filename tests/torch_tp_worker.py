"""One rank of tests/test_torch_tp.py's four-process gloo run on the CPU.

    ALIGN3R_COORDINATOR=localhost:<port> ALIGN3R_NUM_PROCESSES=4 ALIGN3R_PROCESS_ID=<r> \\
        CUDA_VISIBLE_DEVICES= python tests/torch_tp_worker.py <dir>

<dir> holds what the test wrote (weights.pth, engine.npz). The worker joins
the group once and runs the tensor-parallel engine on make_mesh(2, 2), then
on make_mesh(1, 4), in the same world; every rank writes its whole result
to <dir>/tp_<n_data>x<n_model>.rank<r>.npz. Imports the port only (no jax).
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from align3r_tpu_torch.inference.engine import inference  # noqa: E402
from align3r_tpu_torch.models.align3r import Align3R  # noqa: E402
from align3r_tpu_torch.models.config import TINY_TEST  # noqa: E402
from align3r_tpu_torch.parallel.mesh import (make_mesh, maybe_init_distributed,  # noqa: E402
                                             rank, world_size)

torch.set_num_threads(1)
LAYOUTS = ((2, 2), (1, 4))
BATCH, CHUNK = 4, 4


def main(d):
    assert maybe_init_distributed() and world_size() == 4
    e = np.load(os.path.join(d, "engine.npz"))
    model = Align3R(TINY_TEST)
    model.load_state_dict(torch.load(os.path.join(d, "weights.pth")), strict=True)
    pm = model.prepare(torch.float32, torch.float32, device="cpu")
    pairs = [tuple(p) for p in e["pairs"]]
    for nd, nm in LAYOUTS:
        out = inference(pairs, pm, e["imgs"], e["priors"], batch_size=BATCH,
                        encode_chunk=CHUNK, mesh=make_mesh(nd, nm))
        np.savez(os.path.join(d, f"tp_{nd}x{nm}.rank{rank()}.npz"),
                 **{f"{k}/{v}": out[k][v].numpy() for k in ("pred1", "pred2") for v in out[k]})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
