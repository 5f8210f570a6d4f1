"""Base two-view dataset: the `_get_views` contract and the common transforms
(port of align3r_tpu/training/data/base.py:23-153).

Behavioural reference: the reference dust3r/datasets/base/
base_stereo_view_dataset.py (__getitem__:106-162, _crop_resize_if_necessary:
181-242, resolutions 163-179) and dust3r/utils/misc.py's transposition.

Subclasses implement __len__ and `_get_views(idx, resolution, rng)`, which
returns per-view dicts with: img (uint8 (H, W, 3)), depthmap (H, W),
pred_depth (H, W, 3 prior pointcloud), camera_pose (4, 4 cam2world),
camera_intrinsics (3, 3). __getitem__ adds pts3d / valid_mask (by
unprojection, then the pose through `geometry.core.geotrf` in fp32),
normalises the image to [-1, 1] HWC and transposes portrait views to
landscape. The datasets take part in the `N @ d`, `d + d` and `N * d`
algebra (`EasyDataset`).
"""
from __future__ import annotations

import numpy as np
import torch

from align3r_tpu_torch.geometry.core import (depthmap_to_camera_coords, geotrf,
                                             pixel_to_pointcloud)
from align3r_tpu_torch.training.data import cropping
from align3r_tpu_torch.training.data.easy_dataset import EasyDataset


class BaseStereoViewDataset(EasyDataset):
    def __init__(self, *, split=None, resolution=None, transform=None,
                 aug_crop=False, aug_f=False, seed=None,
                 depth_prior_name="depthpro", num_views=2):
        # `transform` is accepted and ignored, as in the JAX package
        self.split = split
        self.aug_crop = aug_crop
        self.aug_f = aug_f
        self.seed = seed
        self.depth_prior_name = depth_prior_name
        self.num_views = num_views
        self._set_resolutions(resolution)

    def _set_resolutions(self, resolutions):
        assert resolutions is not None, "undefined resolution"
        if not isinstance(resolutions, list):
            resolutions = [resolutions]
        self._resolutions = []
        for r in resolutions:
            w, h = (r, r) if isinstance(r, int) else r
            assert w >= h, "resolutions are (W, H) with W >= H"
            self._resolutions.append((int(w), int(h)))

    @property
    def resolutions(self):
        return list(self._resolutions)

    def __len__(self):
        raise NotImplementedError

    def _get_views(self, idx, resolution, rng):
        raise NotImplementedError

    @staticmethod
    def pixel_to_pointcloud(depth, focal):
        return pixel_to_pointcloud(torch.from_numpy(np.asarray(depth, np.float32)),
                                   focal).numpy()

    def _crop_resize_if_necessary(self, image, depthmap, pred_depth,
                                  intrinsics, resolution, rng, info=None):
        """Principal-point-centred crop -> optional augmentations -> rescale
        -> final crop to `resolution` (reference 181-242), drawing from `rng`
        in the JAX package's order."""
        W, H = cropping.image_size(image)
        cx, cy = np.round(intrinsics[:2, 2]).astype(int)
        mx = min(cx, W - cx)
        my = min(cy, H - cy)
        bbox = (cx - mx, cy - my, cx + mx, cy + my)
        image, depthmap, pred_depth, intrinsics = cropping.crop_image_depthmap(
            image, depthmap, pred_depth, intrinsics, bbox)

        W, H = cropping.image_size(image)
        if H > 1.1 * W:
            resolution = resolution[::-1]
        elif 0.9 < H / W < 1.1 and resolution[0] != resolution[1]:
            if rng.integers(2):
                resolution = resolution[::-1]

        target = np.array(resolution)
        if self.aug_f:
            crop_scale = rng.choice([0.8, 0.9, 1.0])
            image, depthmap, pred_depth, intrinsics = \
                cropping.center_crop_image_depthmap(image, depthmap, pred_depth,
                                                    intrinsics, crop_scale)
        if self.aug_crop and self.aug_crop > 1:
            target = target + rng.integers(0, self.aug_crop)
        image, depthmap, pred_depth, intrinsics = cropping.rescale_image_depthmap(
            image, depthmap, pred_depth, intrinsics, target)
        K2 = cropping.camera_matrix_of_crop(intrinsics, cropping.image_size(image),
                                            resolution, offset_factor=0.5)
        bbox = cropping.bbox_from_intrinsics_in_out(intrinsics, K2, resolution)
        image, depthmap, pred_depth, K2 = cropping.crop_image_depthmap(
            image, depthmap, pred_depth, intrinsics, bbox)
        return image, depthmap, pred_depth, K2

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, ar_idx = idx
        else:
            assert len(self._resolutions) == 1
            ar_idx = 0
        rng = (np.random.default_rng(self.seed + idx) if self.seed
               else getattr(self, "_rng", None) or np.random.default_rng())
        self._rng = rng
        resolution = self._resolutions[ar_idx]
        views = self._get_views(idx, resolution, rng)
        assert len(views) == self.num_views

        for v, view in enumerate(views):
            assert "pts3d" not in view and "valid_mask" not in view
            view["view_idx"] = (idx, ar_idx, v)
            W, H = cropping.image_size(view["img"])
            view["true_shape"] = np.int32((H, W))
            view["img"] = (np.asarray(view["img"], np.float32) / 255.0 - 0.5) / 0.5
            if "camera_pose" not in view:
                view["camera_pose"] = np.full((4, 4), np.nan, np.float32)
            pts_cam, valid = depthmap_to_camera_coords(view["depthmap"],
                                                       view["camera_intrinsics"])
            pose = view["camera_pose"]
            if np.isfinite(pose).all():
                pts = geotrf(torch.as_tensor(pose, dtype=torch.float32),
                             torch.from_numpy(pts_cam)).numpy()
            else:
                pts = pts_cam
            view["pts3d"] = pts.astype(np.float32)
            view["valid_mask"] = (valid[..., 0] &
                                  np.isfinite(pts).all(axis=-1)).astype(bool)
            _transpose_to_landscape(view)
        return views


def _transpose_to_landscape(view):
    """If the view is portrait (H > W), transpose the spatial dims so that
    every batch member is landscape (reference base_stereo_view_dataset.py:
    263-284 + dust3r/utils/misc.py); the intrinsics' rows and columns swap."""
    H, W = view["true_shape"]
    if W >= H:
        return
    for k in ("img", "depthmap", "pred_depth", "pts3d", "valid_mask"):
        view[k] = np.swapaxes(view[k], 0, 1)
    view["true_shape"] = view["true_shape"][::-1].copy()
    K = view["camera_intrinsics"].copy()
    K[[0, 1]] = K[[1, 0]]
    K[:, [0, 1]] = K[:, [1, 0]]
    view["camera_intrinsics"] = K
