"""Per-video reconstruction, the port's entry point (port of
align3r_tpu/pipeline.py).

frames + prior pointclouds -> pair graph -> engine (encoder, dual-stream
decoder, DPT heads; kernels K1, K2) -> optional RAFT flows in both
directions of every edge and self-supervised motion masks -> MST init
(host) -> Adam alignment (kernels K3, K4 on observations packed by K5; the
flow variant adds the ego-flow term and the depth regulariser) ->
SceneResult with poses, focals, intrinsics, depths, confidences, dynamic
masks, sky masking and their savers. `reconstruct_scene_hierarchical` solves
long videos as a coarse keyframe solve and clip solves anchored to it.

With `sam2_mask_refine`, the motion masks are refined by SAM2 video
tracking (models/sam2_refine.py), or only cleaned up when no SAM2 model is
given and no checkpoint is local, as in the JAX pipeline.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from align3r_tpu_torch.inference.pairs import make_pairs
from align3r_tpu_torch.alignment.flow import flow_forward
from align3r_tpu_torch.alignment.init_poses import mst_init
from align3r_tpu_torch.alignment.scene import (
    SceneConfig, SceneData, build_scene, default_masks, depth_to_pts3d,
    get_depthmaps_raw, get_focals, get_im_poses, get_intrinsics,
    get_principal_points, global_alignment_loop, pairwise_pts_loss)
from align3r_tpu_torch.alignment.pair_viewer import motion_masks_from_pairs
from align3r_tpu_torch.eval.trajectory import poses_to_traj, save_tum_trajectory
from align3r_tpu_torch.eval.viz import segment_sky
from align3r_tpu_torch.inference.engine import inference
from align3r_tpu_torch.models.align3r import PreparedAlign3R
from align3r_tpu_torch.models.raft import raft_forward
from align3r_tpu_torch.models.raft1 import raft1_forward
from align3r_tpu_torch.models.sam2_refine import refine_motion_mask_w_sam2
from align3r_tpu_torch.utils.png import write_png


def _np(t):
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class SceneResult:
    cfg: SceneConfig
    data: SceneData
    params: Dict
    losses: np.ndarray
    imgs: Optional[np.ndarray] = None            # (n, H, W, 3) in [-1, 1]
    dynamic_masks: Optional[np.ndarray] = None   # (n, H, W)
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------- getters
    def get_im_poses(self) -> np.ndarray:
        return _np(get_im_poses(self.params))

    def get_focals(self) -> np.ndarray:
        return _np(get_focals(self.params, self.cfg))

    def get_principal_points(self) -> np.ndarray:
        return _np(get_principal_points(self.params, self.data))

    def get_intrinsics(self) -> np.ndarray:
        return _np(get_intrinsics(self.params, self.data, self.cfg))

    def get_depthmaps(self) -> np.ndarray:
        H, W = self.cfg.imshape
        return _np(get_depthmaps_raw(self.params, self.data, self.cfg)
                   ).reshape(self.cfg.n_imgs, H, W)

    def get_pts3d(self) -> np.ndarray:
        H, W = self.cfg.imshape
        return _np(depth_to_pts3d(self.params, self.data, self.cfg)
                   ).reshape(self.cfg.n_imgs, H, W, 3)

    def get_conf(self) -> np.ndarray:
        H, W = self.cfg.imshape
        return _np(self.data.im_conf).reshape(self.cfg.n_imgs, H, W)

    def get_masks(self) -> np.ndarray:
        return self.get_conf() > self.cfg.min_conf_thr

    # -------------------------------------------------------------- savers
    def save_tum_poses(self, path):
        """TUM trajectory: one 'ts x y z qw qx qy qz' line per frame.
        Returns the (N, 7) rows."""
        traj = poses_to_traj(self.get_im_poses())
        save_tum_trajectory(traj, path)
        return traj[0]

    def save_focals(self, path):
        np.savetxt(path, self.get_focals(), fmt="%.6f")

    def save_intrinsics(self, path):
        np.savetxt(path, self.get_intrinsics().reshape(-1, 9), fmt="%.6f")

    def save_depth_maps(self, out_dir, start: int = 0):
        """frame_XXXX.npy depth maps plus a min-max normalised 8-bit
        grayscale frame_XXXX.png preview of each."""
        depths = self.get_depthmaps()
        os.makedirs(out_dir, exist_ok=True)
        for i, d in enumerate(depths):
            np.save(os.path.join(out_dir, f"frame_{i + start:04d}.npy"), d)
            dn = (d - d.min()) / max(d.max() - d.min(), 1e-8)
            write_png((dn * 255).astype(np.uint8),
                      os.path.join(out_dir, f"frame_{i + start:04d}.png"))
        return depths

    def save_conf_maps(self, out_dir, start: int = 0):
        """conf_{i}.npy per frame."""
        confs = self.get_conf()
        os.makedirs(out_dir, exist_ok=True)
        for i, c in enumerate(confs):
            np.save(os.path.join(out_dir, f"conf_{i + start}.npy"), c)
        return confs

    def save_dynamic_masks(self, out_dir, start: int = 0):
        """dynamic_mask_{i}.png per frame, 255 = dynamic (all static when the
        solve had no masks)."""
        masks = (self.dynamic_masks if self.dynamic_masks is not None
                 else np.zeros((self.cfg.n_imgs,) + tuple(self.cfg.imshape), bool))
        os.makedirs(out_dir, exist_ok=True)
        for i, m in enumerate(masks):
            write_png((np.asarray(m) > 0).astype(np.uint8) * 255,
                      os.path.join(out_dir, f"dynamic_mask_{i + start}.png"))
        return masks

    def mask_sky(self):
        """Zero the confidence of HSV-heuristic sky pixels (eval.viz.
        segment_sky) on the device where the scene lives. Returns the new
        (n, H, W) confidences."""
        assert self.imgs is not None
        n, (H, W) = self.cfg.n_imgs, self.cfg.imshape
        sky = np.stack([segment_sky(im * 0.5 + 0.5) for im in self.imgs])
        conf = self.data.im_conf.reshape(n, H, W).clone()
        conf[torch.as_tensor(sky, device=conf.device)] = 0
        self.data = dataclasses.replace(self.data, im_conf=conf.reshape(n, -1))
        return _np(conf)

    def save_rgb_imgs(self, out_dir, start: int = 0):
        """frame_XXXX.png per frame: the input frames as 8-bit RGB."""
        os.makedirs(out_dir, exist_ok=True)
        if self.imgs is None:
            return
        for i, im in enumerate(self.imgs):
            write_png(((im * 0.5 + 0.5) * 255).astype(np.uint8),
                      os.path.join(out_dir, f"frame_{i + start:04d}.png"))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def compute_raft_flows(raft, imgs_01, edges, chunk: int = 12, iters: int = 20):
    """Bidirectional RAFT flow per edge, on the RAFT module's device, in fp32
    (the JAX pipeline's "auto" precision). imgs_01 (n, H, W, 3) in [0, 1].
    Returns flow_ij, flow_ji (E, H, W, 2). Each step runs `chunk` edges in
    both directions as one batch; the ragged tail runs at its own size.
    The module's class says which RAFT it is (JAX passes raft_kind with its
    parameter tree)."""
    fwd = raft1_forward if raft.kind == "raft1" else raft_forward
    dev = next(raft.parameters()).device
    imgs255 = torch.as_tensor(np.asarray(imgs_01), dtype=torch.float32, device=dev) * 255.0
    ei = torch.tensor([e[0] for e in edges], device=dev)
    ej = torch.tensor([e[1] for e in edges], device=dev)
    f_ij, f_ji = [], []
    for s in range(0, len(edges), chunk):
        a, b = imgs255[ei[s:s + chunk]], imgs255[ej[s:s + chunk]]
        fij, fji = torch.chunk(fwd(raft, torch.cat([a, b]), torch.cat([b, a]), iters=iters),
                               2)
        f_ij.append(fij)
        f_ji.append(fji)
    return torch.cat(f_ij), torch.cat(f_ji)


def reconstruct_scene(
    imgs, priors, model: PreparedAlign3R,
    *,
    scene_graph: str = "swinstride-5-noncyclic",
    symmetrize: bool = True,
    batch_size: int = 8,
    variant: str = "flow",                 # 'flow' (demo/pose) | 'prior' (depth)
    mono_depths=None,
    raft_params=None,
    dynamic_masks=None,
    use_self_mask: bool = False,
    sam2_mask_refine: bool = False,
    sam2_model=None,
    init: str = "mst",
    init_priors=None,
    niter: int = 300,
    lr: float = 0.01,
    schedule: str = "linear",
    lr_min: float = 1e-6,
    scene_kw: Optional[Dict] = None,
    seed: int = 0,
    conf_clamp: Optional[float] = None,
    inference_kw: Optional[Dict] = None,
) -> SceneResult:
    """Full per-video solve. imgs (n, H, W, 3) in [-1, 1]; priors
    (n, H, W, 3) normalised prior pointclouds. Runs on the model's device.
    raft_params is a RAFT module (models/raft.py RAFT2 or models/raft1.py
    RAFT1) on that device: with it and flow_loss_weight > 0 the flow variant precomputes
    RAFT flows for every edge (and, with `use_self_mask`, the motion masks)
    and adds the flow term, as in the JAX pipeline; with `sam2_mask_refine`
    too, SAM2 refines those masks: `sam2_model` = (SAM2Video, cfg) from
    sam2_video.load_hf_sam2_video, else the local facebook/sam2.1-hiera-large
    on the model's device, else connected-component cleanup alone.
    SceneResult.timings holds the host seconds of each phase (each ends in a
    device synchronise)."""
    dev = model.device
    timings = {}
    n = imgs.shape[0]
    pairs = make_pairs(n, scene_graph, symmetrize=symmetrize)
    t0 = time.perf_counter()
    output = inference(pairs, model, imgs, priors, batch_size=batch_size,
                       **(inference_kw or {}))
    _sync(dev)
    timings["inference_s"] = time.perf_counter() - t0
    if conf_clamp is not None:
        for k in ("pred1", "pred2"):
            c = output[k]["conf"]
            output[k]["conf"] = torch.where(c > 1, torch.full_like(c, conf_clamp), c)

    scene_kw = dict(scene_kw or {})
    if variant == "flow":
        scene_kw.setdefault("num_total_iter", niter)
    cfg, data, params = build_scene(output, cfg_kw=scene_kw,
                                    mono_depths=mono_depths, seed=seed)

    # flow precompute + motion masks
    if variant == "flow" and cfg.flow_loss_weight > 0 and raft_params is not None:
        t0 = time.perf_counter()
        flow_ij, flow_ji = compute_raft_flows(raft_params, np.asarray(imgs) * 0.5 + 0.5,
                                              pairs)
        _sync(flow_ij.device)
        timings["raft_s"] = time.perf_counter() - t0
        if use_self_mask and dynamic_masks is None:
            t0 = time.perf_counter()
            dynamic_masks = motion_masks_from_pairs(output, flow_ij, flow_ji,
                                                    min_conf_thr=cfg.min_conf_thr)
            timings["masks_s"] = time.perf_counter() - t0
            if sam2_mask_refine:
                t0 = time.perf_counter()
                dynamic_masks = refine_motion_mask_w_sam2(
                    np.asarray(imgs) * 0.5 + 0.5, dynamic_masks,
                    model=None if sam2_model is None else sam2_model[0], device=dev)
                _sync(dev)
                timings["sam2_s"] = time.perf_counter() - t0
        data = dataclasses.replace(data, flow_ij=flow_ij.to(dev), flow_ji=flow_ji.to(dev))
    if dynamic_masks is not None:
        data = dataclasses.replace(
            data, dynamic_masks=torch.as_tensor(np.asarray(dynamic_masks),
                                                dtype=torch.float32, device=dev))

    t0 = time.perf_counter()
    if init == "mst":
        params = mst_init(params, data, cfg, output["pred1"]["conf"],
                          output["pred2"]["conf"], init_priors=init_priors)
    timings["init_s"] = time.perf_counter() - t0
    if variant == "flow" and cfg.depth_regularize_weight > 0:
        data = dataclasses.replace(data, init_depth=get_depthmaps_raw(params, data, cfg))

    masks = default_masks(cfg, params)
    if init_priors is not None:
        masks["im_poses"][0] = 0.0
        masks["im_focals"][0] = 0.0

    loss_fn = flow_forward if variant == "flow" else pairwise_pts_loss
    t0 = time.perf_counter()
    params, losses = global_alignment_loop(params, masks, data, cfg, lr=lr,
                                           niter=niter, schedule=schedule,
                                           lr_min=lr_min, loss_fn=loss_fn)
    losses = _np(losses)
    timings["solve_s"] = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        bad = int(np.flatnonzero(~np.isfinite(losses))[0])
        raise FloatingPointError(
            f"non-finite alignment loss at iter {bad}/{niter} "
            f"(variant={variant}, n_imgs={cfg.n_imgs}, edges={cfg.n_edges})")
    params = {k: v.detach() for k, v in params.items()}
    return SceneResult(cfg=cfg, data=data, params=params, losses=losses,
                       imgs=np.asarray(imgs),
                       dynamic_masks=(None if dynamic_masks is None
                                      else np.asarray(dynamic_masks)),
                       timings=timings)


def reconstruct_scene_hierarchical(
    imgs, priors, model: PreparedAlign3R,
    *, clip_size: int = 10, coarse_niter: int = 300, coarse_lr: float = 0.01,
    niter: int = 300, lr: float = 0.01, **kw
) -> Tuple[List[SceneResult], np.ndarray, np.ndarray]:
    """Long-video solve (port of align3r_tpu/pipeline.py:289-333): a coarse
    complete-graph solve over the keyframes (every clip_size-th frame), then
    one complete-graph solve per clip of clip_size + 1 frames, its first
    frame anchored to the keyframe's coarse pose, depth and focal through
    init_priors. Other keywords go to reconstruct_scene.

    Returns (clip SceneResults, all_poses (n, 4, 4), all_depths (n, H, W))."""
    n = imgs.shape[0]
    keyframes = list(range(0, n, clip_size))
    coarse = reconstruct_scene(imgs[keyframes], priors[keyframes], model,
                               scene_graph="complete", niter=coarse_niter,
                               lr=coarse_lr, **kw)
    key_poses = coarse.get_im_poses()
    key_focals = coarse.get_focals()
    key_depths = coarse.get_depthmaps()

    H, W = imgs.shape[1:3]
    all_poses = np.zeros((n, 4, 4), np.float32)
    all_depths = np.zeros((n, H, W), np.float32)
    results = []
    for ci, start in enumerate(keyframes):
        clip = list(range(start, min(start + clip_size + 1, n)))
        if len(clip) < 2:
            all_poses[start] = key_poses[ci]
            all_depths[start] = key_depths[ci]
            continue
        init_priors = (key_poses[ci], key_depths[ci], [key_focals[ci]])
        res = reconstruct_scene(imgs[clip], priors[clip], model,
                                scene_graph="complete", niter=niter, lr=lr,
                                init_priors=init_priors, **kw)
        results.append(res)
        poses = res.get_im_poses()
        depths = res.get_depthmaps()
        take = len(clip) if clip[-1] == n - 1 else len(clip) - 1
        for k in range(take):
            all_poses[clip[k]] = poses[k]
            all_depths[clip[k]] = depths[k]
    return results, all_poses, all_depths
