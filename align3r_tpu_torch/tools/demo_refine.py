"""The demo, then PromptDA refinement of its depths at the frames' own
resolution (the port of tool/demo_refine.py).

    python -m align3r_tpu_torch.tools.demo_refine --input_dir frames/ \
        --output_dir out/ [--weights align3r_depthpro.pth] \
        [--promptda_model depth-anything/prompt-depth-anything-vitl-hf] \
        [--device cuda | cpu]

The flags are tools.demo's plus `--promptda_model` (a local Hugging Face
folder or a hub name in the local cache). The scene is solved as the JAX
tool solves it (swinstride-5 graph, flow variant, self-supervised motion
masks, RAFT flows when --raft_weights exists); pred_traj.txt,
pred_intrinsics.txt and frame_XXXX.npy are written; then each optimised
depth is the prompt for PromptDA on the on-disk frame (the model-resolution
frames for a video), and frame_XXXX_refined.npy holds the result.

`main(argv, model=...)` takes prepared Align3R weights (tools.demo's
load_model) instead of loading --weights; it returns {"out_dir",
"timings", "refined"}.
"""
from __future__ import annotations

import os
import time

import numpy as np

from align3r_tpu_torch.inference.images import load_images, read_rgb, stack_views
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.models.prompt_da import load_prompt_da, rescale_depth_maps
from align3r_tpu_torch.models.raft import exact_fp32
from align3r_tpu_torch.models.raft1 import load_raft_auto
from align3r_tpu_torch.pipeline import reconstruct_scene
from align3r_tpu_torch.tools.demo import _sync, get_args_parser, load_model


def load_raw_images01(files):
    """The frames at their on-disk resolution, (n, H, W, 3) in [0, 1]."""
    return np.stack([read_rgb(f).astype(np.float32) / 255.0 for f in files])


def main(argv=None, model=None):
    parser = get_args_parser()
    parser.add_argument("--promptda_model",
                        default="depth-anything/prompt-depth-anything-vitl-hf")
    args = parser.parse_args(argv)
    dev = device_or_raise(args.device)
    out_dir = os.path.join(args.output_dir, args.seq_name)
    os.makedirs(out_dir, exist_ok=True)
    timings = {}
    t0 = time.perf_counter()
    if model is None:
        model = load_model(args.weights, args.image_size, dev)
    views = load_images(args.input_dir, args.image_size, verbose=not args.silent,
                        fps=args.fps, interval=args.interval, traj_format="default",
                        depth_prior_name=args.depth_prior_name)
    stacked = stack_views(views)
    raft, flow_w = None, 0.0
    if os.path.exists(args.raft_weights):
        raft, _ = load_raft_auto(args.raft_weights, device=dev)
        flow_w = 0.01
    _sync(dev)
    timings["load_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    scene = reconstruct_scene(
        stacked["imgs"], stacked["priors"], model, scene_graph="swinstride-5-noncyclic",
        variant="flow", raft_params=raft, use_self_mask=True, niter=args.niter, lr=0.01,
        schedule="linear", batch_size=args.batch_size,
        scene_kw=dict(shared_focal=True, temporal_smoothing_weight=0.01,
                      flow_loss_weight=flow_w, flow_loss_start_epoch=0.1,
                      flow_loss_thre=25, min_conf_thr=1.1))
    timings["reconstruct_s"] = time.perf_counter() - t0
    scene.save_tum_poses(os.path.join(out_dir, "pred_traj.txt"))
    scene.save_intrinsics(os.path.join(out_dir, "pred_intrinsics.txt"))
    depths = scene.save_depth_maps(out_dir)

    t0 = time.perf_counter()
    pda, _ = load_prompt_da(args.promptda_model, dev)
    _sync(dev)
    timings["promptda_weights_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    files = [v["instance"] for v in views]
    if all(os.path.isfile(f) for f in files):
        imgs01 = load_raw_images01(files)
    else:       # a video: the model-resolution frames
        imgs01 = np.asarray(scene.imgs) * 0.5 + 0.5
    exact_fp32()
    refined = rescale_depth_maps(pda, imgs01, depths)
    _sync(dev)
    timings["refine_s"] = time.perf_counter() - t0
    for i, d in enumerate(refined):
        np.save(os.path.join(out_dir, f"frame_{i:04d}_refined.npy"), d)
    print(f"Refined {len(refined)} depth maps -> {out_dir}")
    return {"out_dir": out_dir, "timings": timings, "refined": refined}


if __name__ == "__main__":
    main()
