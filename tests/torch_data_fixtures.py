"""Synthetic training folders in the preprocessed layout and in Sintel's raw
layout, written with the port's own writers (JPEG, PNG, PFM, .dpt; .cam
with numpy), so that no imaging library is needed to make them. Used by the
port's data tests on the CPU and by its card test."""
import os

import numpy as np

from align3r_tpu_torch.utils.jpeg import write_jpeg
from align3r_tpu_torch.utils.pfm import write_pfm
from align3r_tpu_torch.utils.png import write_png
from align3r_tpu_torch.utils.sintel_io import TAG_FLOAT, depth_write


def frame_image(rng, h, w):
    """Smooth colour fields plus noise: content on every scale of the DCT."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([128 + 90 * np.sin(xx / (9 + 4 * c) + yy / 13 + ph[c]) for c in range(3)],
                   -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def pose_at(k):
    """cam2world: a small yaw and a sideways step per frame."""
    a = 0.03 * k
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    pose[:3, 3] = [0.1 * k, 0.02 * k, 0.05 * k]
    return pose


def write_preprocessed_scene(d, n, hw, seed, world2cam=False, pp_shift=(0, 0), quality=75):
    """n frames of (H, W) in `d`: _rgb.jpg, _depth.pfm (a few zeros, a few
    beyond 400), _mask.png, _metadata.npz (cam2world, or world2cam), and a
    DepthPro-style _rgb_pred_depth_depthpro.npz."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    H, W = hw
    for k in range(n):
        stem = os.path.join(d, f"frame_{k:04d}")
        write_jpeg(frame_image(rng, H, W), stem + "_rgb.jpg", quality)
        depth = rng.uniform(1, 5, (H, W)).astype(np.float32)
        depth[rng.uniform(size=(H, W)) < 0.05] = 0
        depth[rng.uniform(size=(H, W)) < 0.01] = 450
        write_pfm(stem + "_depth.pfm", depth)
        write_png(np.where(rng.uniform(size=(H, W)) < 0.1, 0, 255).astype(np.uint8),
                  stem + "_mask.png")
        K = np.array([[80, 0, W / 2 + pp_shift[0]], [0, 82, H / 2 + pp_shift[1]], [0, 0, 1]],
                     np.float32)
        pose = pose_at(k)
        np.savez(stem + "_metadata.npz", camera_intrinsics=K,
                 camera_pose=np.linalg.inv(pose) if world2cam else pose)
        np.savez(stem + "_rgb_pred_depth_depthpro.npz",
                 depth=rng.uniform(1, 5, (1, H, W)).astype(np.float32),
                 focallength_px=np.float32(80.0 + k))


def write_cam(path, K, world2cam):
    with open(path, "wb") as f:
        np.float32(TAG_FLOAT).tofile(f)
        np.asarray(K, np.float64).tofile(f)
        np.asarray(world2cam, np.float64)[:3].tofile(f)


def write_sintel_scene(root, scene, n, hw, seed):
    """Sintel's raw layout under root: MPI-Sintel-training_images/training/
    final/<scene>/frame_XXXX.png, and the .dpt depth, the
    dynamic_label_perfect mask and the camdata_left .cam under
    MPI-Sintel-depth-training/training, the prior .npz under
    .../training/depth_prediction_depthpro. Returns the `final` folder."""
    rng = np.random.default_rng(seed)
    H, W = hw
    final = os.path.join(root, "MPI-Sintel-training_images", "training", "final")
    depth_root = os.path.join(root, "MPI-Sintel-depth-training", "training")
    prior = os.path.join(root, "MPI-Sintel-training_images", "training",
                         "depth_prediction_depthpro", scene)
    dirs = [os.path.join(final, scene), prior] + [
        os.path.join(depth_root, s, scene) for s in ("depth", "dynamic_label_perfect",
                                                     "camdata_left")]
    for p in dirs:
        os.makedirs(p, exist_ok=True)
    for k in range(1, n + 1):
        name = f"frame_{k:04d}"
        write_png(frame_image(rng, H, W), os.path.join(final, scene, name + ".png"))
        depth_write(os.path.join(depth_root, "depth", scene, name + ".dpt"),
                    rng.uniform(2, 9, (H, W)).astype(np.float32))
        write_png(np.where(rng.uniform(size=(H, W)) < 0.1, 0, 255).astype(np.uint8),
                  os.path.join(depth_root, "dynamic_label_perfect", scene, name + ".png"))
        K = np.array([[W * 0.9, 0, W / 2 - 0.5], [0, W * 0.9, H / 2 + 0.5], [0, 0, 1]])
        write_cam(os.path.join(depth_root, "camdata_left", scene, name + ".cam"), K,
                  np.linalg.inv(pose_at(k)))
        np.savez(os.path.join(prior, name + ".npz"),
                 depth=rng.uniform(2, 9, (H, W)).astype(np.float32),
                 focallength_px=np.float32(W * 0.9))
    return final
