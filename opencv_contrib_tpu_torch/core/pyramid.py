"""Depth pyramids — the port of the KinFu half of
opencv_contrib_tpu/core/pyramid.py (pyrDownBilateral, kinfu_frame.cpp:255).
Pyramids are tuples of tensors, finest first."""

from __future__ import annotations

import torch


def pyr_down_depth(depth: torch.Tensor, sigma_depth: float = 0.02) -> torch.Tensor:
    """Depth-aware half-resolution downsample: the mean of each 2x2 block
    over the pixels close to the block's first (top-left) depth, zeros kept
    invalid."""
    H2, W2 = depth.shape[0] // 2, depth.shape[1] // 2
    blocks = depth[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2).permute(0, 2, 1, 3).reshape(H2, W2, 4)
    ref = blocks[..., 0]
    valid = (blocks > 0) & (torch.abs(blocks - ref[..., None]) < 3.0 * sigma_depth)
    cnt = valid.sum(dim=-1)
    s = torch.where(valid, blocks, 0.0).sum(dim=-1)
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), 0.0)


def build_depth_pyramid(depth: torch.Tensor, levels: int, sigma_depth: float = 0.02):
    pyr = [depth]
    for _ in range(levels - 1):
        pyr.append(pyr_down_depth(pyr[-1], sigma_depth))
    return tuple(pyr)
