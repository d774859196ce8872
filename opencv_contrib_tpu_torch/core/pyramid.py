"""Gaussian and depth image pyramids — the port of
opencv_contrib_tpu/core/pyramid.py: cv::pyrDown / pyrUp chains for the
coarse-to-fine flow, and KinFu's pyrDownBilateral (kinfu_frame.cpp:255).
Pyramids are tuples of tensors, finest first."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.cuda import pyramid as pyr_kernels

PYR_KERNEL = pyr_kernels.pyr_kernel()


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Gaussian 5-tap blur (reflect-101 border) + 2x decimation
    (cv::pyrDown): (H, W) -> (ceil(H/2), ceil(W/2)). A CUDA tensor goes
    through the pyrdown kernel, a CPU tensor the plain version."""
    return pyr_kernels.pyrdown(img)


def pyr_up(img: torch.Tensor) -> torch.Tensor:
    """2x zero-stuffed upsample + 5-tap blur (cv::pyrUp semantics)."""
    H, W = img.shape[:2]
    up = torch.zeros((2 * H, 2 * W) + tuple(img.shape[2:]), dtype=img.dtype, device=img.device)
    up[::2, ::2] = img
    k = PYR_KERNEL.to(img.device) * 2.0
    return filters.sep_filter2d(up, k, k)


def build_pyramid(img: torch.Tensor, levels: int):
    """[full-res, half, quarter, ...] — `levels` entries."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return tuple(pyr)


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
