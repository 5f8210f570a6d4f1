"""Video -> depth + pose demo on the port (the port of tool/demo.py).

    python -m align3r_tpu_torch.tools.demo --input_dir frames/ --output_dir out/ \
        [--weights align3r_depthpro.pth] [--raft_weights ...-M.pth] \
        [--mode eval_pose | eval_pose_h] [--device cuda | cpu]

Loads a folder of frames (or a video) with their cached monocular priors
(`<frame>_pred_depth_<prior>.npz`), runs the sliding-window pair graph
through the network, solves the flow-variant global alignment (with RAFT
flows and motion masks when the RAFT weights exist) and writes the artifact
set: pred_traj.txt, pred_intrinsics.txt, pred_focals.txt, frame_XXXX.npy
depth maps, conf_i.npy, dynamic_mask_i.png, frame_XXXX.png frames,
scene.html and scene.glb. Under `--mode eval_pose_h` a video longer than
clip_size + 1 frames is solved hierarchically and only pred_traj.txt and
depth_maps.npy are written, as the JAX demo does.

The flags and defaults are tool/demo.py's, plus `--device`: the demo runs
on the card unless asked for the CPU, and raises without CUDA. Without a
weights file it uses seeded random VIT_L_512 weights (a structure demo).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from align3r_tpu_torch import compat
from align3r_tpu_torch.eval.glb import export_scene_result_glb
from align3r_tpu_torch.eval.html_viewer import export_scene_result_html
from align3r_tpu_torch.eval.trajectory import poses_to_traj, save_tum_trajectory
from align3r_tpu_torch.inference.images import load_images, stack_views
from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
from align3r_tpu_torch.models.config import VIT_L_512
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.models.raft1 import load_raft_auto
from align3r_tpu_torch.pipeline import reconstruct_scene, reconstruct_scene_hierarchical


def get_args_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_size", type=int, default=512, choices=[512, 224])
    parser.add_argument("--weights", type=str, default="align3r_depthpro.pth",
                        help="path to the Align3R torch checkpoint")
    parser.add_argument("--output_dir", type=str, default="./demo_tmp")
    parser.add_argument("--input_dir", type=str, default="")
    parser.add_argument("--seq_name", type=str, default="bear")
    parser.add_argument("--depth_prior_name", type=str, default="depthpro",
                        choices=["depthpro", "depthanything"])
    parser.add_argument("--use_gt_davis_masks", action="store_true", default=False)
    parser.add_argument("--fps", type=int, default=0)
    parser.add_argument("--interval", type=int, default=30)
    parser.add_argument("--mode", type=str, default="eval_pose",
                        choices=["eval_pose", "eval_pose_h"])
    parser.add_argument("--raft_weights", type=str,
                        default="third_party/RAFT/models/Tartan-C-T432x960-M.pth")
    parser.add_argument("--niter", type=int, default=300)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--silent", action="store_true", default=False)
    parser.add_argument("--clip_size", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser


def load_model(weights, image_size, device="cuda"):
    """The prepared serving weights on `device` (bf16 trunk, fp32 heads, as
    the JAX demo's engine runs them): the checkpoint's, or seeded random
    VIT_L_512 ones when the file does not exist."""
    if weights and os.path.exists(weights):
        return compat.load_model(weights, device, verbose=False).prepared()
    print(f"!! weights {weights!r} not found: using random ViT-L init "
          f"(structure demo only)")
    dev = device_or_raise(device)
    with torch.device(dev):
        model = Align3R(VIT_L_512)
    init_align3r_(model, seed=0)
    return compat.Align3RModel(model, dev).prepared()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, model=None):
    """Runs the demo; returns {"out_dir", "timings"} (host seconds of each
    stage, each ending in a device synchronise). `model`: prepared weights
    (load_model's) to run instead of loading --weights."""
    args = get_args_parser().parse_args(argv)
    dev = device_or_raise(args.device)
    out_dir = os.path.join(args.output_dir, args.seq_name)
    os.makedirs(out_dir, exist_ok=True)
    timings = {}
    if model is None:
        t0 = time.perf_counter()
        model = load_model(args.weights, args.image_size, dev)
        _sync(dev)
        timings["weights_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    views = load_images(args.input_dir, args.image_size, verbose=not args.silent,
                        fps=args.fps, interval=args.interval, traj_format="default",
                        depth_prior_name=args.depth_prior_name,
                        dynamic_mask_root=None)
    stacked = stack_views(views)
    timings["frames_s"] = time.perf_counter() - t0

    raft, flow_w = None, 0.0
    if os.path.exists(args.raft_weights):
        raft, _ = load_raft_auto(args.raft_weights, device=dev)
        flow_w = 0.01

    scene_kw = dict(shared_focal=True, temporal_smoothing_weight=0.01,
                    translation_weight=1.0, flow_loss_weight=flow_w,
                    flow_loss_start_epoch=0.1, flow_loss_thre=25,
                    min_conf_thr=1.1)
    common = dict(variant="flow", raft_params=raft,
                  use_self_mask=not args.use_gt_davis_masks,
                  dynamic_masks=(stacked["dynamic_masks"]
                                 if args.use_gt_davis_masks else None),
                  niter=args.niter, lr=0.01, schedule="linear",
                  batch_size=args.batch_size, scene_kw=scene_kw)

    t0 = time.perf_counter()
    if args.mode == "eval_pose_h" and len(views) > args.clip_size + 1:
        results, poses, depths = reconstruct_scene_hierarchical(
            stacked["imgs"], stacked["priors"], model, clip_size=args.clip_size, **common)
        timings["reconstruct_s"] = time.perf_counter() - t0
        for r in results:   # the clip solves' stages (the coarse solve is not returned)
            for k, v in r.timings.items():
                timings["clips_" + k] = timings.get("clips_" + k, 0.0) + v
        t0 = time.perf_counter()
        save_tum_trajectory(poses_to_traj(poses), os.path.join(out_dir, "pred_traj.txt"))
        np.save(os.path.join(out_dir, "depth_maps.npy"), depths)
    else:
        scene = reconstruct_scene(stacked["imgs"], stacked["priors"], model,
                                  scene_graph="swinstride-5-noncyclic", **common)
        timings["reconstruct_s"] = time.perf_counter() - t0
        timings.update(scene.timings)
        t0 = time.perf_counter()
        scene.save_tum_poses(os.path.join(out_dir, "pred_traj.txt"))
        scene.save_intrinsics(os.path.join(out_dir, "pred_intrinsics.txt"))
        scene.save_focals(os.path.join(out_dir, "pred_focals.txt"))
        scene.save_depth_maps(out_dir)
        scene.save_conf_maps(out_dir)
        scene.save_dynamic_masks(out_dir)
        scene.save_rgb_imgs(out_dir)
        export_scene_result_html(scene, os.path.join(out_dir, "scene.html"),
                                 title=args.seq_name)
        export_scene_result_glb(scene, os.path.join(out_dir, "scene.glb"))
    timings["writers_s"] = time.perf_counter() - t0
    print(f"Processing completed. Output saved in {out_dir}")
    return {"out_dir": out_dir, "timings": timings}


if __name__ == "__main__":
    main()
