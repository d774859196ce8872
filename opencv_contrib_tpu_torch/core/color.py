"""Colour conversion (the port of opencv_contrib_tpu/core/color.py's
`rgb_to_gray`, the cvtColor the reference's pipelines call before feature
extraction, e.g. xfeatures2d/src/surf.cpp:929)."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops.cuda import transform


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W) float32, ITU-R BT.601 weights (matches
    OpenCV): one grid_transform over the three channels, read in place."""
    x = img.to(torch.float32)
    if x.ndim < 3 or x.shape[-1] != 3:
        raise ValueError(f"rgb_to_gray: takes (..., H, W, 3), got {tuple(x.shape)}")
    lead, W = x.shape[:-2], x.shape[-2]
    rows = x.reshape(-1, W, 3)  # a view for a contiguous image
    g = transform.grid_transform(transform.gray(), rows[..., 0], rows[..., 1], rows[..., 2])
    return g.reshape(*lead, W)
