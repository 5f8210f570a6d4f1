"""Video depth evaluation on Sintel / Bonn / TUM / DAVIS / PointOdyssey /
FlyingThings3D (the port of tool/depth_test.py).

    python -m align3r_tpu_torch.tools.depth_test --eval_dataset sintel \
        --output_dir out/ [--weights align3r_depthpro.pth] [--if_use_mono] \
        [--align lad] [--no_promptda] [--device cuda | cpu]

Per sequence (reference tool/depth_test.py:551-835): the prior-variant
solve, hierarchical (keyframes, then clips) past --crop_size + 1 frames,
the per-pixel mono scalemaps with --if_use_mono; the optimised depths
refined by PromptDA at the frames' resolution when its weights are a local
folder or in the local Hugging Face cache (else bilinear upsampling), at the
ground truth's own resolution; one scale and shift a sequence (LAD by
default); AbsRel / SqRel / RMSE / LogRMSE / delta metrics and their
pixel-weighted average over the dataset.

Protocol notes as in the JAX tool: at most 110 frames a sequence;
PointOdyssey / FlyingThings3D take '*_rgb.jpg' frames with '*_depth.pfm'
ground truth beside them; DAVIS has no ground-truth depth and scores against
the monocular prior; FlyingThings3D takes every 20th TEST sequence. The
flags are the JAX tool's, plus `--device` (the card unless "cpu" is asked
for).
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from align3r_tpu_torch.eval.depth_metrics import average_metrics, evaluate_sequence_depth
from align3r_tpu_torch.eval.metadata import dataset_metadata, process_slice
from align3r_tpu_torch.inference.images import load_images, prior_depth_path, stack_views
from align3r_tpu_torch.models.nn import bilinear_resize, device_or_raise
from align3r_tpu_torch.models.prompt_da import load_prompt_da, rescale_depth_maps
from align3r_tpu_torch.models.raft import exact_fp32
from align3r_tpu_torch.pipeline import reconstruct_scene, reconstruct_scene_hierarchical
from align3r_tpu_torch.tools import demo
from align3r_tpu_torch.tools.demo_refine import load_raw_images01
from align3r_tpu_torch.utils.pfm import read_pfm
from align3r_tpu_torch.utils.sintel_io import depth_read

MAX_FRAMES = 110  # reference load_images_my caps at 110 frames (ref 273)


def get_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--eval_dataset", type=str, default="sintel",
                   choices=["sintel", "bonn", "tum", "davis", "PointOdyssey",
                            "FlyingThings3D"])
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--output_postfix", type=str, default="")
    p.add_argument("--weights", type=str, default="align3r_depthpro.pth")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--niter", type=int, default=300)
    p.add_argument("--schedule", type=str, default="cosine")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--min_conf_thr", type=float, default=1.1)
    p.add_argument("--depth_prior_name", type=str, default="depthpro")
    p.add_argument("--if_use_mono", action="store_true", default=False,
                   help="optimise per-pixel log scalemaps + shifts on top of "
                        "the frozen monocular prior depths")
    p.add_argument("--depth_max", type=float, default=70.0)
    p.add_argument("--align", type=str, default="lad",
                   choices=["lad", "lad2", "lstsq", "scale", "median"])
    p.add_argument("--crop_size", type=int, default=50, help="clip size")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--no_promptda", action="store_true", default=False,
                   help="skip PromptDA full-res refinement even if weights "
                        "are cached (bilinear upsampling instead)")
    p.add_argument("--promptda_model", type=str,
                   default="depth-anything/prompt-depth-anything-vitl-hf")
    p.add_argument("--full_seq", action="store_true", default=False)
    p.add_argument("--seq_list", nargs="+", default=None)
    p.add_argument("--n_proc", type=int, default=1)
    p.add_argument("--proc_id", type=int, default=0)
    p.add_argument("--overwrite", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def list_frames(dataset, img_dir):
    """Frame files for a sequence with the per-protocol filter
    (reference supported_images_extensions, depth_test.py:256-261)."""
    if dataset in ("PointOdyssey", "FlyingThings3D"):
        exts = ("rgb.jpg", ".jpeg", "rgb.png")
    else:
        exts = (".jpg", ".jpeg", ".png")
    files = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))
             if f.lower().endswith(exts)]
    return files[:MAX_FRAMES]


def _read_depth_png16(path):
    """A 16-bit depth PNG (Bonn / TUM), through Pillow."""
    import PIL.Image
    return np.asarray(PIL.Image.open(path), np.float32)


def load_gt_depths(dataset, img_files, depth_prior_name="depthpro"):
    """Ground-truth depths at their native resolution (the reference never
    downsizes them; predictions are upsampled to them), or None."""
    first = img_files[0]
    if dataset == "sintel":
        paths = [f.replace("MPI-Sintel-training_images", "MPI-Sintel-depth-training")
                 .replace("clean/", "depth/").replace(".png", ".dpt") for f in img_files]
        paths = [p if os.path.exists(p) else p.replace("/clean", "/depth").replace(".png", ".dpt")
                 for p in paths]
        if not os.path.exists(paths[0]):
            return None
        return np.stack([depth_read(p) for p in paths])
    if dataset in ("bonn", "tum"):
        tag = "rgb_110" if dataset == "bonn" else "rgb_50"
        ddir = os.path.dirname(first).replace(tag, tag.replace("rgb", "depth"))
        if not os.path.isdir(ddir):
            return None
        files = sorted(glob.glob(os.path.join(ddir, "*.png")))[:len(img_files)]
        # 16-bit depth PNG / 5000 (TUM convention; ref depth_read_bonn:197)
        return np.stack([_read_depth_png16(f) / 5000.0 for f in files]) if files else None
    if dataset in ("PointOdyssey", "FlyingThings3D"):
        paths = [f.replace("_rgb.jpg", "_depth.pfm").replace("_rgb.png", "_depth.pfm")
                 for f in img_files]
        if not os.path.exists(paths[0]):
            return None
        return np.stack([np.ascontiguousarray(read_pfm(p)) for p in paths])
    if dataset == "davis":
        # no GT depth: the reference scores against the raw monocular prior
        # (depth_test.py:333 depth = pred_depth1)
        out = []
        for f in img_files:
            p = prior_depth_path(f, "davis", depth_prior_name)
            if not os.path.exists(p):
                return None
            out.append(np.squeeze(np.asarray(np.load(p, allow_pickle=True)["depth"])))
        return np.stack(out)
    return None


def resize_linear(arr, h, w):
    """cv2.resize(arr, (w, h)) (INTER_LINEAR: half-pixel centres, no
    antialiasing) of float (n, H, W[, C]) arrays, as torch's bilinear."""
    x = torch.as_tensor(np.asarray(arr, np.float32))
    x = x[..., None] if x.dim() == 3 else x
    y = bilinear_resize(x, h, w, align_corners=False)
    return (y[..., 0] if np.ndim(arr) == 3 else y).numpy()


def upsample_predictions(depths, img_files, gt_hw, promptda=None):
    """Predicted depths (n, h, w) at model resolution -> (n, H, W) at the
    ground truth's. With PromptDA (a loaded model): prompt-conditioned
    refinement on the raw frames (reference rescale_depth_maps,
    depth_test.py:535-549), the frames first resized to the ground truth's
    resolution where they differ; without: bilinear upsampling (the
    reference's documented alternative, 692)."""
    H, W = gt_hw
    if promptda is not None:
        raw = load_raw_images01(img_files)
        if raw.shape[1:3] != (H, W):   # PromptDA targets the raw-frame resolution
            raw = resize_linear(raw, H, W)
        return rescale_depth_maps(promptda, raw, depths)
    return resize_linear(depths, H, W)


def maybe_load_promptda(args, device):
    """PromptDA from a local folder or the local cache, else None."""
    if args.no_promptda:
        return None
    try:
        return load_prompt_da(args.promptda_model, device)[0]
    except FileNotFoundError as e:
        print(f"PromptDA unavailable ({type(e).__name__}); "
              "using bilinear upsampling to GT resolution")
        return None


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    dev = device_or_raise(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    meta = dataset_metadata[args.eval_dataset]
    seqs = args.seq_list or meta.sequences(args.full_seq or None)
    seqs = process_slice(seqs, args.n_proc, args.proc_id)

    model = demo.load_model(args.weights, args.image_size, dev)
    promptda = maybe_load_promptda(args, dev)
    per_seq = []
    for seq in seqs:
        # resume interrupted sweeps (reference eval_metadata skip_condition)
        done = os.path.join(args.output_dir, f"{seq.replace('/', '_')}_depths.npy")
        if not args.overwrite and os.path.exists(done):
            print(f"skip {seq} (done; --overwrite to redo)")
            continue
        img_files = list_frames(args.eval_dataset, meta.seq_dir(meta.img_path, seq))
        views = load_images(img_files, args.image_size,
                            traj_format=meta.traj_format or args.eval_dataset,
                            depth_prior_name=args.depth_prior_name)
        stacked = stack_views(views)
        n = stacked["imgs"].shape[0]
        # the prior pointcloud's z channel (normalised) as frozen mono depth
        mono = stacked["priors"][..., 2].reshape(n, -1) if args.if_use_mono else None
        common = dict(variant="prior", mono_depths=mono, niter=args.niter, lr=args.lr,
                      schedule=args.schedule, batch_size=args.batch_size, conf_clamp=10.0,
                      scene_kw=dict(min_conf_thr=args.min_conf_thr))
        if n > args.crop_size + 1:
            _, _, depths = reconstruct_scene_hierarchical(
                stacked["imgs"], stacked["priors"], model, clip_size=args.crop_size, **common)
        else:
            depths = reconstruct_scene(stacked["imgs"], stacked["priors"], model,
                                       scene_graph="complete", **common).get_depthmaps()
        np.save(done, depths)

        gt = load_gt_depths(args.eval_dataset, img_files, args.depth_prior_name)
        if gt is not None and args.eval:
            # evaluate at the GT's resolution: upsample the predictions
            # (PromptDA or bilinear), never downsize the GT (ref 690-763)
            gt = gt[:depths.shape[0]]
            exact_fp32()
            pred_full = upsample_predictions(depths[:gt.shape[0]], img_files[:gt.shape[0]],
                                             gt.shape[1:3], promptda)
            m = evaluate_sequence_depth(pred_full, gt, align=args.align,
                                        depth_max=args.depth_max, device=dev)
            m["seq"] = seq
            per_seq.append(m)
            print(seq, {k: round(v, 4) for k, v in m.items() if isinstance(v, float)})

    if per_seq:
        avg = average_metrics([{k: v for k, v in m.items() if k != "seq"} for m in per_seq])
        print("Average depth evaluation metrics:", avg)
        with open(os.path.join(args.output_dir, f"_metrics_{args.proc_id}.txt"), "w") as f:
            for k, v in avg.items():
                f.write(f"{k}: {v}\n")
            f.write(f"valid_pixels: {sum(m['valid_pixels'] for m in per_seq)}\n")
    return per_seq


if __name__ == "__main__":
    main()
