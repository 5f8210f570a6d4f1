"""Training datasets over the preprocessed on-disk layout (port of
align3r_tpu/training/data/datasets.py:56-216).

Behavioural reference: the reference dust3r/datasets/my_*.py. Every
preprocessed dataset shares the frame-file convention
  <stem>_rgb.jpg, <stem>_depth.pfm, <stem>_mask.png, <stem>_metadata.npz
  (+ <stem>_rgb_pred_depth_<prior>.npz monocular prior),
and differs only in scene discovery, the temporal pairing window, and
whether camera_pose in metadata is cam2world or world2cam. Sintel reads the
raw MPI-Sintel files instead (my_sintel.py:85-140).

No imaging library is needed: `_rgb.jpg` frames are read by the port's
JPEG decoder (`utils.jpeg`, the bits cv2.imread gives), PNG frames and masks
by `utils.png`, PFM depth by `utils.pfm`, Sintel's `.dpt` / `.cam` by
`utils.sintel_io`.
"""
from __future__ import annotations

import itertools
import os
import os.path as osp
from glob import glob

import numpy as np

from align3r_tpu_torch.inference.images import read_rgb
from align3r_tpu_torch.training.data.base import BaseStereoViewDataset
from align3r_tpu_torch.utils.pfm import read_pfm
from align3r_tpu_torch.utils.png import read_png
from align3r_tpu_torch.utils.sintel_io import cam_read, depth_read

__all__ = ["PreprocessedSequenceDataset", "SceneFlowDatasets", "PointodysseyDatasets",
           "SpringDatasets", "TartanairDatasets", "VkittiDatasets", "SintelDatasets",
           "read_pfm"]


def _masked(depth, mask_path):
    """Depth zeroed where an 8-bit mask PNG is at most 10% of full scale."""
    if osp.exists(mask_path):
        m = read_png(mask_path).astype(np.float32)
        depth = depth * ((m / 255.0) > 0.1)
    return depth


class PreprocessedSequenceDataset(BaseStereoViewDataset):
    """Shared machinery for the *_rgb.jpg layout."""

    dataset_label = "Preprocessed"
    invert_pose = False        # metadata camera_pose is world2cam?
    pair_window = 10

    def __init__(self, *args, split=None, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, split=split, **kwargs)
        self.pairs = []
        for scene in self._scene_list(split):
            imgs = sorted(glob(osp.join(scene, "*_rgb.jpg")))
            for i, j in itertools.combinations(range(len(imgs)), 2):
                if abs(i - j) <= self.pair_window:
                    self.pairs.append((imgs[i], imgs[j]))

    def _scene_list(self, split):
        return sorted(osp.join(self.ROOT, s) for s in os.listdir(self.ROOT))

    def __len__(self):
        return len(self.pairs)

    def _load_view(self, img_path):
        rgb = read_rgb(img_path)
        depth = read_pfm(img_path.replace("_rgb.jpg", "_depth.pfm")).astype(np.float32)
        depth = _masked(depth, img_path.replace("_rgb.jpg", "_mask.png"))
        prior = np.load(img_path.replace(".jpg", "_pred_depth_"
                                         + self.depth_prior_name + ".npz"))
        focal = np.asarray(prior["focallength_px"])
        if focal.shape == (3, 3):
            focal = focal[0][0]
        pred_depth = self.pixel_to_pointcloud(np.squeeze(prior["depth"]), float(focal))
        meta = np.load(img_path.replace("_rgb.jpg", "_metadata.npz"))
        K = np.float32(meta["camera_intrinsics"])
        pose = np.float32(meta["camera_pose"])
        if self.invert_pose:
            pose = np.linalg.inv(pose)
        return rgb, depth, pred_depth, K, pose

    def _get_views(self, idx, resolution, rng):
        views = []
        for img_path in self.pairs[idx]:
            rgb, depth, pred_depth, K, pose = self._load_view(img_path)
            rgb, depth, pred_depth, K = self._crop_resize_if_necessary(
                rgb, depth, pred_depth, K, resolution, rng, info=img_path)
            views.append(dict(img=rgb, depthmap=depth, camera_pose=pose,
                              camera_intrinsics=K, dataset=self.dataset_label,
                              label=img_path, instance=img_path,
                              pred_depth=pred_depth))
        return views


class SceneFlowDatasets(PreprocessedSequenceDataset):
    """my_sceneflow.py:108-206: Driving / Monkaa / FlyingThings3D, |i-j| <= 10."""
    dataset_label = "SceneFlow"

    def _scene_list(self, split):
        if split != "train":
            return sorted(glob(osp.join(self.ROOT, "FlyingThings3D_proc", "TEST", "*/*/*")))
        return (sorted(glob(osp.join(self.ROOT, "Driving_proc", "*/*/*/*")))
                + sorted(glob(osp.join(self.ROOT, "Monkaa_proc", "*/*")))
                + sorted(glob(osp.join(self.ROOT, "FlyingThings3D_proc", "TRAIN", "*/*/*"))))


class PointodysseyDatasets(PreprocessedSequenceDataset):
    """my_PointOdyssey.py:57-124: |i-j| <= 10, poses stored world2cam."""
    dataset_label = "Pointodyssey"
    invert_pose = True


class SpringDatasets(PreprocessedSequenceDataset):
    """my_spring.py: |i-j| <= 10, poses world2cam."""
    dataset_label = "Spring"
    invert_pose = True


class TartanairDatasets(PreprocessedSequenceDataset):
    """my_Tartanair.py: |i-j| <= 10."""
    dataset_label = "Tartanair"


class VkittiDatasets(PreprocessedSequenceDataset):
    """my_vkitti2.py: |i-j| <= 10."""
    dataset_label = "Vkitti"


class SintelDatasets(BaseStereoViewDataset):
    """Raw MPI-Sintel frames (my_sintel.py:55-140): |i-j| <= 3, gt depth zeroed
    at dynamic pixels (dynamic_label_perfect), extrinsics are world2cam .cam
    files."""
    dataset_label = "Sintel"

    def __init__(self, *args, split=None, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, split=split, **kwargs)
        self.pairs = []
        for scene in sorted(os.listdir(ROOT)):
            imgs = sorted(glob(osp.join(ROOT, scene, "*.png")))
            for i, j in itertools.combinations(range(len(imgs)), 2):
                if abs(i - j) <= 3:
                    self.pairs.append((imgs[i], imgs[j]))

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, resolution, rng):
        views = []
        for img_path in self.pairs[idx]:
            rgb = read_rgb(img_path)

            def sub(a, b):
                return img_path.replace("MPI-Sintel-training_images",
                                        "MPI-Sintel-depth-training").replace(a, b)
            depth = depth_read(sub("final/", "depth/").replace("clean/", "depth/")
                               .replace(".png", ".dpt"))
            depth = _masked(depth, sub("final/", "dynamic_label_perfect/")
                            .replace("clean/", "dynamic_label_perfect/"))
            tag = "depth_prediction_" + self.depth_prior_name
            prior = np.load(img_path.replace("final", tag).replace("clean", tag)
                            .replace(".png", ".npz"))
            pred_depth = self.pixel_to_pointcloud(
                np.squeeze(prior["depth"]),
                float(np.asarray(prior["focallength_px"]).ravel()[0]))
            K, N = cam_read(sub("final/", "camdata_left/").replace("clean/", "camdata_left/")
                            .replace(".png", ".cam"))
            K = np.float32(K)
            R, t = np.float32(N[:3, :3]), np.float32(N[:3, 3])
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = R.T
            pose[:3, 3] = -R.T @ t
            rgb, depth, pred_depth, K = self._crop_resize_if_necessary(
                rgb, depth.astype(np.float32), pred_depth, K, resolution, rng,
                info=img_path)
            views.append(dict(img=rgb, depthmap=depth, camera_pose=pose,
                              camera_intrinsics=K, dataset=self.dataset_label,
                              label=img_path, instance=img_path,
                              pred_depth=pred_depth))
        return views
