"""Cached monocular prior depths for a folder of frames (the port of
tool/prior_depth.py).

    python -m align3r_tpu_torch.tools.prior_depth --input_dir frames/ \
        [--depth_prior_name depthanything | depthpro] [--model_path ...] \
        [--batch_size 4] [--device cuda | cpu]

For each frame, Depth Anything V2 (relative depth, pseudo-focal 200) or
Depth Pro (metric depth and a focal) writes `<frame>_pred_depth_<prior>.npz`
with `depth` (the frame's H x W) and `focallength_px`, the files the demo
(`tools.demo`) reads beside the frames. `--model_path` is a local Hugging
Face folder or a hub name already in the local cache (read by
`utils.hf_weights`; nothing is fetched). The prior runs on the card unless
`--device cpu` is asked for, and raises without CUDA.

`main(argv, model=...)` takes a (model, cfg) pair instead of loading one,
and returns {"files", "timings"}.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from align3r_tpu_torch.inference.images import read_rgb, resize_pil
from align3r_tpu_torch.models import nn as L
from align3r_tpu_torch.models.depth_anything import load_depth_anything, preprocess
from align3r_tpu_torch.models.depth_pro import load_depth_pro, postprocess_depth
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.models.raft import exact_fp32
from align3r_tpu_torch.tools.demo import _sync

DA_PSEUDO_FOCAL = 200.0   # the relative prior's focal (reference image_pose.py:300-302)


def get_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--depth_prior_name", default="depthanything",
                   choices=["depthanything", "depthpro"])
    p.add_argument("--model_path", default="depth-anything/Depth-Anything-V2-Large-hf",
                   help="HF folder or cached hub name (depthanything or depthpro)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def load_prior(args, dev):
    if args.depth_prior_name == "depthanything":
        return load_depth_anything(args.model_path, dev)
    path = (args.model_path if args.model_path and "Depth-Anything" not in args.model_path
            else "apple/DepthPro-hf")
    return load_depth_pro(path, dev)


@torch.inference_mode()
def main(argv=None, model=None):
    args = get_args_parser().parse_args(argv)
    dev = device_or_raise(args.device)
    exact_fp32()
    frames = sorted(f for f in os.listdir(args.input_dir)
                    if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if not frames:
        raise FileNotFoundError(f"no frames in {args.input_dir}")
    timings = {"weights_s": 0.0, "frames_s": 0.0, "model_s": 0.0, "write_s": 0.0}
    t0 = time.perf_counter()
    net, cfg = load_prior(args, dev) if model is None else model
    _sync(dev)
    timings["weights_s"] = time.perf_counter() - t0
    da = args.depth_prior_name == "depthanything"

    written = []
    for s in range(0, len(frames), args.batch_size):
        chunk = frames[s:s + args.batch_size]
        t0 = time.perf_counter()
        imgs = [read_rgb(os.path.join(args.input_dir, f)) for f in chunk]
        H0, W0 = imgs[0].shape[:2]
        batch = np.stack([im if im.shape == imgs[0].shape else
                          resize_pil(im, W0, H0, "bicubic") for im in imgs])
        x01 = torch.from_numpy(batch.astype(np.float32) / 255.0).to(dev)
        timings["frames_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        if da:
            depth = net(preprocess(x01, cfg))
            focals = None
        else:
            S = cfg.image_size
            x = (L.resize(x01, S, S, "bilinear") - 0.5) / 0.5
            depth, focals = postprocess_depth(*net(x), S)
        _sync(dev)
        timings["model_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for k, f in enumerate(chunk):
            H, W = imgs[k].shape[:2]
            d = L.resize(depth[k:k + 1], H, W, "bilinear")[0].cpu().numpy()
            # Depth Pro's focal is for the square input: scale it to this width
            f_px = DA_PSEUDO_FOCAL if da else float(focals[k]) * W / depth.shape[-1]
            out = os.path.join(args.input_dir,
                               os.path.splitext(f)[0] + f"_pred_depth_{args.depth_prior_name}.npz")
            np.savez(out, depth=d.astype(np.float32), focallength_px=np.float32(f_px))
            written.append(out)
            print("wrote", out)
        timings["write_s"] += time.perf_counter() - t0
    return {"files": written, "timings": timings}


if __name__ == "__main__":
    main()
