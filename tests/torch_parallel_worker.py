"""One rank of tests/test_torch_parallel.py's two-process gloo runs on the CPU.

    ALIGN3R_COORDINATOR=localhost:<port> ALIGN3R_NUM_PROCESSES=2 ALIGN3R_PROCESS_ID=<r> \\
        CUDA_VISIBLE_DEVICES= python tests/torch_parallel_worker.py <dir>

<dir> holds what the test wrote (weights.pth, batch.npz, engine.npz); the
worker joins the group once and runs, in order, the data-parallel engine,
a train step under DDP and under ZeRO-1 (with the ZeRO-1 optimizer's
gathered state_dict and its round trip through load_state_dict), and
train() with ZeRO-1 and asynchronous checkpoints, then with pickle
checkpoints, each resumed from its checkpoints; rank 0 writes each result
to <dir>. Imports the port only (no jax).
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from align3r_tpu_torch.inference.engine import inference  # noqa: E402
from align3r_tpu_torch.models.align3r import Align3R, init_align3r_  # noqa: E402
from align3r_tpu_torch.models.config import TINY_TEST, Align3RConfig  # noqa: E402
from align3r_tpu_torch.parallel.mesh import maybe_init_distributed, rank, world_size  # noqa: E402
from align3r_tpu_torch.training import step as ts  # noqa: E402
from align3r_tpu_torch.training.data import EasyDataset  # noqa: E402
from align3r_tpu_torch.training.train import TrainArgs, train  # noqa: E402

torch.set_num_threads(1)
KW = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, dec_embed_dim=48,
          dec_depth=8, dec_num_heads=4)
STEP_CFG = Align3RConfig(img_size=(32, 32), **KW)
MICRO_STEPS, ACCUM, LR = 4, 2, 1e-4
TRAIN_MODEL = ("Align3RConfig(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, "
                "enc_num_heads=4, dec_embed_dim=48, dec_depth=8, dec_num_heads=4)")


class Interrupted(Exception):
    pass


class Pairs(EasyDataset):
    """n two-view 32 x 32 samples from a seed; set_epoch(fail_at) raises,
    to interrupt a run."""

    resolutions = [(32, 32)]

    def __init__(self, n, seed=0, fail_at=None):
        self.n, self.seed, self.fail_at = n, seed, fail_at

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        if epoch == self.fail_at:
            raise Interrupted(f"before epoch {epoch}")

    def __getitem__(self, idx):
        idx = idx[0] if isinstance(idx, tuple) else idx
        r = np.random.default_rng(1000 * self.seed + idx)

        def view():
            return {"img": r.standard_normal((32, 32, 3)).astype(np.float32),
                    "pred_depth": r.uniform(0, 1, (32, 32, 3)).astype(np.float32),
                    "pts3d": (r.standard_normal((32, 32, 3)) + [0, 0, 4]).astype(np.float32),
                    "camera_pose": np.eye(4, dtype=np.float32),
                    "valid_mask": r.uniform(0, 1, (32, 32)) > 0.1 + 0.05 * (idx % 3),
                    "instance": f"{idx}"}
        return [view(), view()]


def train_args(out, **kw):
    # no test set: a checkpoint-best would double the disk a run takes (600 MB)
    base = dict(model=TRAIN_MODEL, train_dataset=Pairs(8), test_dataset="",
                batch_size=4, accum_iter=2, epochs=2, warmup_epochs=0, lr=1e-3,
                num_workers=1, output_dir=str(out), keep_freq=5, print_freq=1,
                remat="none", device="cpu")
    base.update(kw)
    return TrainArgs(**base)


def run_steps(model, batch, zero1, lo=0, hi=None):
    """MICRO_STEPS micro-steps (ACCUM a update) of make_train_step in fp32 on
    rows lo:hi of the global batch. Returns (metrics, optimizer)."""
    opt = ts.make_optimizer(model, ts.make_lr_schedule(LR, LR / 100, 0, 10, 10),
                            weight_decay=0.0, accum_iter=ACCUM, zero1=zero1)
    step = ts.make_train_step(model, opt, dtype=torch.float32, remat="none")
    local = {vn: {k: torch.from_numpy(v[lo:hi]) for k, v in bv.items()}
             for vn, bv in batch.items()}
    ms = [{k: v.item() for k, v in step(local).items()} for _ in range(MICRO_STEPS)]
    return ms, opt


def load_batch(path):
    z = np.load(path)
    return {vn: {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith(vn + "/")}
            for vn in ("view1", "view2")}


def main(d):
    assert maybe_init_distributed() and world_size() == 2
    me = rank()
    # the data-parallel engine
    e = np.load(os.path.join(d, "engine.npz"))
    model = init_align3r_(Align3R(TINY_TEST), seed=0)
    pm = model.prepare(torch.float32, torch.float32, device="cpu")
    out = inference([tuple(p) for p in e["pairs"]], pm, e["imgs"], e["priors"],
                    batch_size=4, encode_chunk=2, group=dist.group.WORLD)
    # and without a group while one is up: this rank alone, nothing gathered
    alone = inference([tuple(p) for p in e["pairs"]], pm, e["imgs"], e["priors"],
                      batch_size=4, encode_chunk=2)
    if me == 0:
        for name, o in (("engine_out.npz", out), ("engine_alone.npz", alone)):
            np.savez(os.path.join(d, name), **{f"{k}/{v}": o[k][v].numpy()
                                               for k in ("pred1", "pred2") for v in o[k]})
    # a train step under DDP and under ZeRO-1 on this rank's half of the batch
    batch = load_batch(os.path.join(d, "batch.npz"))
    B = batch["view1"]["img"].shape[0]
    for zero1 in (False, True):
        model = Align3R(STEP_CFG)
        model.load_state_dict(torch.load(os.path.join(d, "weights.pth")), strict=True)
        ms, opt = run_steps(model, batch, zero1, me * B // 2, (me + 1) * B // 2)
        split = [i for i, dd in enumerate(opt.dims) if dd is not None]
        if zero1:
            # every rank gathers; the whole state loads back into the slices
            sd = opt.state_dict()
            opt.load_state_dict(sd)
            again = opt.state_dict()
            for j, st in sd["adamw"]["state"].items():
                for k, v in st.items():
                    assert torch.equal(again["adamw"]["state"][j][k], v), (j, k)
            if me == 0:
                torch.save(sd, os.path.join(d, "zero1_state_dict.pth"))
        if me == 0:
            torch.save({"metrics": ms, "split": [opt.names[i] for i in split],
                        "shard_shapes": {opt.names[i]: tuple(opt.shards[i].shape)
                                         for i in split},
                        "params": {n: p.detach() for n, p in zip(opt.names, opt.params)}},
                       os.path.join(d, f"step_zero1_{int(zero1)}.pth"))
    # train(): ZeRO-1 and asynchronous, then pickle checkpoints, each resumed
    for backend, run, log in (("orbax", "run", "train_log.json"),
                              ("pickle", "run_pickle", "train_log_pickle.json")):
        out_dir = os.path.join(d, run)
        first = train(train_args(out_dir, n_data=2, zero1=True, ckpt_backend=backend))
        second = train(train_args(out_dir, n_data=2, zero1=True, ckpt_backend=backend,
                                   epochs=3))
        if me == 0:
            with open(os.path.join(d, log), "w") as f:
                json.dump({"first": first.log, "second": second.log,
                           "first_history": first.history,
                           "second_history": second.history}, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
