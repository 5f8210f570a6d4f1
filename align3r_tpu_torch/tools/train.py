"""Training launcher (the port of tool/train.py).

    python -m align3r_tpu_torch.tools.train \
        --train_dataset "1000 @ SceneFlowDatasets(split='train', ROOT='...', resolution=[(512,288)], seed=None)" \
        --test_dataset "100 @ SceneFlowDatasets(split='test', ROOT='...', resolution=[(512,288)], seed=777)" \
        --pretrained dust3r_512.pth --lr 5e-5 --epochs 50 --batch_size 2 --accum_iter 4 \
        [--device cuda | cpu]

Every flag of tool/train.py, and `--device`: training runs on the card
unless `--device cpu` is asked for, and raises without CUDA. Data-parallel
training (training/train.py): `torchrun --nproc_per_node N -m
align3r_tpu_torch.tools.train ... [--n_data N] [--zero1] [--ckpt_backend
orbax]`, `--batch_size` being the global batch; or N processes with
ALIGN3R_COORDINATOR=host:port, ALIGN3R_NUM_PROCESSES=N, ALIGN3R_PROCESS_ID=r. The dataset
expressions are read by `training.data.build_dataset` over the preprocessed
layout (`*_rgb.jpg` frames are decoded by the port's own JPEG decoder, so no
imaging library is needed). `main(argv)` returns the `TrainResult`.
"""
from __future__ import annotations

import argparse

from align3r_tpu_torch.training.train import TrainArgs, TrainResult, train


def get_args_parser():
    p = argparse.ArgumentParser()
    d = TrainArgs()
    p.add_argument("--model", default=d.model)
    p.add_argument("--pretrained", default=None)
    p.add_argument("--train_dataset", required=True)
    p.add_argument("--test_dataset", default="")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--accum_iter", type=int, default=d.accum_iter)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--min_lr", type=float, default=d.min_lr)
    p.add_argument("--warmup_epochs", type=int, default=d.warmup_epochs)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--num_workers", type=int, default=d.num_workers)
    p.add_argument("--output_dir", default=d.output_dir)
    p.add_argument("--eval_freq", type=int, default=d.eval_freq)
    p.add_argument("--save_freq", type=int, default=d.save_freq)
    p.add_argument("--keep_freq", type=int, default=d.keep_freq)
    p.add_argument("--print_freq", type=int, default=d.print_freq)
    p.add_argument("--profile", action="store_true", default=False,
                   help="torch.profiler trace of the first epoch in output_dir/profile")
    p.add_argument("--head_bf16", action="store_true", default=False,
                   help="bf16 DPT conv pyramid in the train forward (fp32 final "
                        "conv + postprocess); the default keeps the reference's "
                        "fp32-head AMP boundary")
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--n_data", type=int, default=None,
                   help="data-parallel ranks, one GPU each (default: the world size)")
    p.add_argument("--zero1", action="store_true", default=False,
                   help="split the Adam moments and accumulation over the ranks")
    p.add_argument("--ckpt_backend", default=d.ckpt_backend, choices=("pickle", "orbax"),
                   help="'orbax': asynchronous torch.distributed.checkpoint saves")
    p.add_argument("--device", default=d.device, help="cuda (default) or cpu")
    return p


def main(argv=None) -> TrainResult:
    return train(TrainArgs(**vars(get_args_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
