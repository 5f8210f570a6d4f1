"""The general traffic generator: videos made from --seed by the parameters
of a traffic file (`benchmark/traffic/<mix>.json`).

A video is `frames` uint8 RGB frames of `height` x `width`: a smooth random
field (a coarse grid of colours upsampled bicubically) with fine noise on
top, drifting a few pixels from frame to frame, drawn on the device from a
generator seeded by (seed, video index). Every video of a mix has the same
size, so every seed does the same work; the seed changes only the content.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

WARMUP_VIDEO = 1 << 20      # the index of the set-up's warm-up video


def video_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + int(index) * 7919 + 17) % (2 ** 63 - 1)


def make_video(traffic: dict, seed: int, index: int, device) -> torch.Tensor:
    """Frames (n, H, W, 3) uint8 on the host."""
    n, H, W = traffic["frames"], traffic["height"], traffic["width"]
    g = torch.Generator(device=device).manual_seed(video_seed(seed, index))
    coarse = torch.rand(1, 3, 9, 17, generator=g, device=device)
    big = F.interpolate(coarse, size=(H + 2 * n, W + 2 * n), mode="bicubic", align_corners=False)
    shift = torch.randint(-1, 2, (n, 2), generator=g, device=device).cumsum(0) + n
    fine = torch.rand(n, 3, H // 4, W // 4, generator=g, device=device)
    fine = F.interpolate(fine, size=(H, W), mode="bilinear", align_corners=False)
    frames = []
    for k in range(n):
        y, x = int(shift[k, 0]), int(shift[k, 1])
        frames.append(big[0, :, y:y + H, x:x + W] * 0.8 + fine[k] * 0.2)
    v = torch.stack(frames).clamp(0, 1).mul(255).round().to(torch.uint8)
    return v.permute(0, 2, 3, 1).contiguous().cpu()
