"""Camera pose evaluation on Sintel / Bonn / TUM / ScanNet / DAVIS / KITTI
(the port of tool/pose_test.py).

    python -m align3r_tpu_torch.tools.pose_test --eval_dataset sintel \
        --output_dir out/ [--weights align3r_depthpro.pth] [--hierarchical] \
        [--device cuda | cpu]

Per sequence (reference tool/pose_test.py:31-299): frames and priors, the
swinstride-5 graph (shrunk for short sequences), the flow-variant solve
(RAFT flows and the flow term when --raft_weights exists), ATE / RPE
against the ground truth after a Sim(3) alignment; --hierarchical solves
keyframes, then clips anchored to them. The sequence list is sharded across
processes (--n_proc, --proc_id); a sequence that fails is logged to
_error_log_<proc_id>.txt and skipped. The flags are the JAX tool's, plus
`--device` (the card unless "cpu" is asked for).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from align3r_tpu_torch.eval.metadata import dataset_metadata, process_slice
from align3r_tpu_torch.eval.trajectory import (eval_metrics, load_traj, plot_trajectory,
                                               poses_to_traj, save_tum_trajectory)
from align3r_tpu_torch.inference.images import load_images, stack_views
from align3r_tpu_torch.models.nn import device_or_raise
from align3r_tpu_torch.models.raft1 import load_raft_auto
from align3r_tpu_torch.models.sam2_refine import SAM2_MODEL, sam2_available
from align3r_tpu_torch.models.sam2_video import load_hf_sam2_video
from align3r_tpu_torch.pipeline import reconstruct_scene, reconstruct_scene_hierarchical
from align3r_tpu_torch.tools import demo


def get_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--eval_dataset", type=str, default="sintel",
                   choices=["davis", "kitti", "bonn", "scannet", "tum", "sintel"])
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--weights", type=str, default="align3r_depthpro.pth")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--niter", type=int, default=300)
    p.add_argument("--pose_schedule", type=str, default="linear")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--min_conf_thr", type=float, default=1.1)
    p.add_argument("--flow_loss_weight", type=float, default=0.01)
    p.add_argument("--flow_loss_start_epoch", type=float, default=0.1)
    p.add_argument("--flow_loss_thre", type=float, default=25)
    p.add_argument("--temporal_smoothing_weight", type=float, default=0.01)
    p.add_argument("--translation_weight", type=float, default=1.0)
    p.add_argument("--shared_focal", action="store_true", default=True)
    p.add_argument("--use_gt_mask", action="store_true", default=False)
    p.add_argument("--use_self_mask", action="store_true", default=True)
    p.add_argument("--sam2_mask_refine", action="store_true", default=False)
    p.add_argument("--motion_mask_thre", type=float, default=0.35)
    p.add_argument("--raft_weights", type=str,
                   default="third_party/RAFT/models/Tartan-C-T432x960-M.pth")
    p.add_argument("--depth_prior_name", type=str, default="depthpro")
    p.add_argument("--overwrite", action="store_true", default=False,
                   help="re-run sequences whose outputs already exist")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--interval_frame", type=int, default=10 ** 9)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--full_seq", action="store_true", default=False)
    p.add_argument("--seq_list", nargs="+", default=None)
    p.add_argument("--n_proc", type=int, default=1)
    p.add_argument("--proc_id", type=int, default=0)
    p.add_argument("--hierarchical", action="store_true", default=False,
                   help="keyframe coarse solve + per-clip anchored solves "
                        "(reference pose_test.py:300-549)")
    p.add_argument("--clip_size", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    dev = device_or_raise(args.device)
    os.makedirs(args.output_dir, exist_ok=True)

    meta = dataset_metadata[args.eval_dataset]
    seqs = args.seq_list or meta.sequences(args.full_seq or None)
    seqs = process_slice(seqs, args.n_proc, args.proc_id)

    model = demo.load_model(args.weights, args.image_size, dev)
    raft_params = None
    if args.flow_loss_weight > 0 and os.path.exists(args.raft_weights):
        raft_params, _ = load_raft_auto(args.raft_weights, device=dev)
    # SAM2 is loaded once for every sequence where a checkpoint is local;
    # without one, --sam2_mask_refine cleans the motion masks up only
    sam2 = (load_hf_sam2_video(SAM2_MODEL, device=dev)
            if args.sam2_mask_refine and sam2_available() else None)

    err_log = os.path.join(args.output_dir, f"_error_log_{args.proc_id}.txt")
    ates, rpes_t, rpes_r = [], [], []
    for seq in seqs:
        # resume interrupted sweeps: skip already-evaluated sequences
        # (reference eval_metadata.py skip_condition)
        done = os.path.join(args.output_dir, seq, "pred_traj.txt")
        if not args.overwrite and os.path.exists(done):
            print(f"skip {seq} (done; --overwrite to redo)")
            continue
        try:
            img_dir = meta.seq_dir(meta.img_path, seq)
            views = load_images(img_dir, args.image_size,
                                traj_format=meta.traj_format or "sintel",
                                depth_prior_name=args.depth_prior_name,
                                start=args.start_frame,
                                interval=args.interval_frame)
            stacked = stack_views(views)
            n = stacked["imgs"].shape[0]
            winsize = 5 if n >= 11 else max((n - 1) // 2, 1)
            scene_kw = dict(
                shared_focal=args.shared_focal,
                temporal_smoothing_weight=args.temporal_smoothing_weight,
                translation_weight=args.translation_weight,
                flow_loss_weight=(args.flow_loss_weight if raft_params is not None else 0.0),
                flow_loss_start_epoch=args.flow_loss_start_epoch,
                flow_loss_thre=args.flow_loss_thre,
                min_conf_thr=args.min_conf_thr)
            common = dict(
                variant="flow", raft_params=raft_params,
                use_self_mask=args.use_self_mask and not args.use_gt_mask,
                sam2_mask_refine=args.sam2_mask_refine, sam2_model=sam2,
                niter=args.niter, lr=args.lr, schedule=args.pose_schedule,
                batch_size=args.batch_size, scene_kw=scene_kw)
            seq_dir = os.path.join(args.output_dir, seq)
            os.makedirs(seq_dir, exist_ok=True)
            if args.hierarchical:
                # keyframe coarse solve + per-clip solves anchored via
                # init_priors (reference pose_test.py:300-549, clip graphs
                # from my_make_pairs:357-397)
                clip_size = args.clip_size
                # floor at 2: the reference's shrink loop (pose_test.py:379)
                # decrements to 0 and ZeroDivisionErrors for n <= 4; short
                # sequences just use one clip (= non-hierarchical)
                while clip_size > 2 and (n % clip_size in (0, 1)
                                         or clip_size > n):
                    clip_size -= 1
                clip_size = max(clip_size, 2)
                results, all_poses, all_depths = reconstruct_scene_hierarchical(
                    stacked["imgs"], stacked["priors"], model,
                    clip_size=clip_size, coarse_niter=args.niter,
                    coarse_lr=args.lr, **common)
                scene = results[-1]
                pred_traj = poses_to_traj(all_poses)
                save_tum_trajectory(pred_traj, os.path.join(seq_dir, "pred_traj.txt"))
                scene.save_intrinsics(os.path.join(seq_dir, "pred_intrinsics.txt"))
                for i, d in enumerate(all_depths):
                    np.save(os.path.join(seq_dir, f"frame_{i:04d}.npy"), d)
            else:
                scene = reconstruct_scene(
                    stacked["imgs"], stacked["priors"], model,
                    scene_graph=f"swinstride-{winsize}-noncyclic",
                    dynamic_masks=(stacked["dynamic_masks"] if args.use_gt_mask else None),
                    **common)
                pred_traj = poses_to_traj(scene.get_im_poses())
                scene.save_tum_poses(os.path.join(seq_dir, "pred_traj.txt"))
                scene.save_intrinsics(os.path.join(seq_dir, "pred_intrinsics.txt"))
                scene.save_depth_maps(seq_dir)
                scene.save_dynamic_masks(seq_dir)

            gt_file = meta.gt_traj(meta.img_path, meta.anno_path, seq)
            if gt_file and os.path.exists(gt_file):
                gt_traj = load_traj(gt_file, meta.traj_format or "sintel")
                ate, rt, rr = eval_metrics(
                    pred_traj, gt_traj, seq=seq,
                    filename=os.path.join(args.output_dir, f"{seq}_eval.txt"))
                plot_trajectory(pred_traj, gt_traj, title=seq,
                                filename=os.path.join(seq_dir, "traj_plot"))
                ates.append(ate); rpes_t.append(rt); rpes_r.append(rr)
                print(f"{seq}: ATE={ate:.5f} RPE-t={rt:.5f} RPE-r={rr:.5f}")
        except Exception as e:  # per-sequence failure tolerance (ref 252-265)
            with open(err_log, "a") as f:
                f.write(f"{seq}: {type(e).__name__}: {e}\n")
            print(f"!! {seq} failed: {e}")

    if ates:
        print(f"Avg ATE: {np.mean(ates):.5f}  Avg RPE trans: {np.mean(rpes_t):.5f}  "
              f"Avg RPE rot: {np.mean(rpes_r):.5f}  ({len(ates)} seqs)")
        with open(os.path.join(args.output_dir, f"_results_{args.proc_id}.txt"), "w") as f:
            f.write(f"ate {np.mean(ates)}\nrpe_trans {np.mean(rpes_t)}\n"
                    f"rpe_rot {np.mean(rpes_r)}\nn {len(ates)}\n")
    return {"ate": ates, "rpe_trans": rpes_t, "rpe_rot": rpes_r}


if __name__ == "__main__":
    main()
