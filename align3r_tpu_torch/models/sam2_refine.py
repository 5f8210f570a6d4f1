"""SAM2 video refinement of the self-supervised motion masks (port of
align3r_tpu/models/sam2_refine.py).

Seed SAM2 video tracking with the motion masks on odd frames, propagate,
take the propagated masks on even frames; repeat with the roles swapped; OR
the result into the input masks (`sam2_video.refine_motion_masks`), then
drop small islands and fill small holes. Without a local SAM2 checkpoint
(`utils.hf_weights.resolve` finds no folder and no cached snapshot) the
masks get the cleanup alone, as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from align3r_tpu_torch.eval.viz import remove_small_regions
from align3r_tpu_torch.models.raft import exact_fp32
from align3r_tpu_torch.models.sam2_video import load_hf_sam2_video, refine_motion_masks
from align3r_tpu_torch.utils import hf_weights

SAM2_MODEL = "facebook/sam2.1-hiera-large"


def cleanup_masks(masks: np.ndarray, min_area: int = 64) -> np.ndarray:
    """Drop islands and fill holes of fewer than `min_area` pixels, per frame."""
    out = []
    for m in np.asarray(masks).astype(bool):
        m = remove_small_regions(m, min_area, mode="islands")
        out.append(remove_small_regions(m, min_area, mode="holes"))
    return np.stack(out)


def sam2_available(model_name: str = SAM2_MODEL) -> bool:
    """Whether `model_name` is a local folder or a snapshot in the local
    Hugging Face cache."""
    try:
        hf_weights.resolve(model_name)
        return True
    except FileNotFoundError:
        return False


def refine_motion_mask_w_sam2(images01: np.ndarray, dynamic_masks: np.ndarray,
                              model_name: str = SAM2_MODEL, min_area: int = 64, model=None,
                              device="cuda") -> np.ndarray:
    """images01 (n, H, W, 3) in [0, 1]; dynamic_masks (n, H, W) bool.
    Returns the refined masks (n, H, W) bool. `model` (a SAM2Video) skips
    the checkpoint lookup; otherwise `model_name` is loaded on
    `device` if it is local, and the masks only cleaned up if it is not."""
    masks = np.asarray(dynamic_masks).astype(bool)
    if model is None:
        if not sam2_available(model_name):
            return cleanup_masks(masks, min_area)
        model, _ = load_hf_sam2_video(model_name, device=device)
    exact_fp32()
    return cleanup_masks(refine_motion_masks(model, images01, masks), min_area)
