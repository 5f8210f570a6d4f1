"""Evaluation dataset registry (port of align3r_tpu/eval/metadata.py).

Behavioural reference: the reference dust3r/utils/eval_metadata.py:6-93.
Declarative: each entry gives path templates and sequence lists for
tools.pose_test and tools.depth_test. `process_slice` shards a sequence
list across processes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence


@dataclass
class DatasetMeta:
    img_path: str
    anno_path: Optional[str] = None
    mask_path: Optional[str] = None
    traj_format: Optional[str] = None
    seq_list: Optional[List[str]] = None
    full_seq: bool = False
    seq_dir: Callable[[str, str], str] = lambda img_path, seq: os.path.join(img_path, seq)
    gt_traj: Callable[[str, Optional[str], str], Optional[str]] = \
        lambda img_path, anno_path, seq: None
    mask_dir: Callable[[Optional[str], str], Optional[str]] = lambda mask_path, seq: None
    skip_if_done: bool = False
    bottom_level: bool = False   # sequences = deepest dirs (get_bottom_level_directories)
    seq_stride: int = 1          # e.g. FlyingThings3D TEST[::20] (depth_test.py:606)

    def sequences(self, full_seq: Optional[bool] = None) -> List[str]:
        full = self.full_seq if full_seq is None else full_seq
        if not full and self.seq_list:
            return list(self.seq_list)
        if os.path.isdir(self.img_path):
            if self.bottom_level:
                out = []
                for root, dirs, _files in os.walk(self.img_path):
                    if not dirs:
                        out.append(os.path.relpath(root, self.img_path))
                return sorted(out)[::self.seq_stride]
            return sorted(d for d in os.listdir(self.img_path)
                          if os.path.isdir(os.path.join(self.img_path, d)))
        return list(self.seq_list or [])


SINTEL_SEQS = ["alley_2", "ambush_4", "ambush_5", "ambush_6", "cave_2", "cave_4",
               "market_2", "market_5", "market_6", "shaman_3", "sleeping_1",
               "sleeping_2", "temple_2", "temple_3"]
BONN_SEQS = ["balloon2", "crowd2", "crowd3", "person_tracking2", "synchronous"]

dataset_metadata = {
    "davis": DatasetMeta(
        img_path="./data/davis/DAVIS/JPEGImages/480p",
        mask_path="./data/davis/DAVIS/Annotations/480p",
        traj_format="davis", full_seq=True,
        mask_dir=lambda mask_path, seq: os.path.join(mask_path, seq)),
    "test": DatasetMeta(img_path="./data/test_set", full_seq=True),
    "bonn": DatasetMeta(
        img_path="./data/bonn/rgbd_bonn_dataset",
        traj_format="bonn", seq_list=BONN_SEQS,
        seq_dir=lambda p, s: os.path.join(p, f"rgbd_bonn_{s}", "rgb_110"),
        gt_traj=lambda p, a, s: os.path.join(p, f"rgbd_bonn_{s}", "groundtruth_110.txt")),
    "scannet": DatasetMeta(
        img_path="./data/scannetv2", traj_format="scannet", full_seq=True,
        seq_dir=lambda p, s: os.path.join(p, s, "color_30"),
        gt_traj=lambda p, a, s: os.path.join(p, s, "pose_30.txt"),
        skip_if_done=True),
    "tum": DatasetMeta(
        img_path="./data/tum", traj_format="tum", full_seq=True,
        seq_dir=lambda p, s: os.path.join(p, s, "rgb_50"),
        gt_traj=lambda p, a, s: os.path.join(p, s, "groundtruth_50.txt")),
    "kitti": DatasetMeta(
        img_path="./data/kitti/depth_selection/val_selection_cropped/image_gathered",
        traj_format="kitti", full_seq=True),
    "sintel": DatasetMeta(
        img_path="./data/sintel/training/clean",
        anno_path="./data/sintel/training/camdata_left",
        traj_format="sintel", seq_list=SINTEL_SEQS, full_seq=True,
        gt_traj=lambda p, a, s: os.path.join(a, s)),
    # video-depth protocols (reference depth_test.py:596-606): preprocessed
    # *_rgb.jpg / *_depth.pfm layouts, deepest dirs are sequences
    "PointOdyssey": DatasetMeta(
        img_path="./data/PointOdyssey_proc/val", full_seq=True,
        bottom_level=True),
    "FlyingThings3D": DatasetMeta(
        img_path="./data/SceneFlow/FlyingThings3D_proc/TEST", full_seq=True,
        bottom_level=True, seq_stride=20),
}


def process_slice(items: Sequence, n_proc: int = 1, proc_id: int = 0):
    """Process `proc_id` of `n_proc`'s share of a work list (every n_proc-th
    item; JAX parallel/mesh.py process_slice, with one process by default
    where JAX reads its process count)."""
    return list(items)[proc_id::n_proc]
