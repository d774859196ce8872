"""Colour conversion (the port of opencv_contrib_tpu/core/color.py's
`rgb_to_gray`, `rgb_to_hsv` and `rgb_to_ycrcb`; gray is the cvtColor the
reference's pipelines call before feature extraction, e.g.
xfeatures2d/src/surf.cpp:929)."""

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


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) in [0, 1] -> HSV with H in [0, 360). The hue's wrap is
    `torch.remainder`, which takes the divisor's sign as `jnp.mod` does."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    safe = torch.where(diff == 0, 1.0, diff)
    h = torch.where(mx == r, 60.0 * ((g - b) / safe),
                    torch.where(mx == g, 60.0 * ((b - r) / safe) + 120.0, 60.0 * ((r - g) / safe) + 240.0))
    h = torch.where(diff == 0, 0.0, torch.remainder(h, 360.0))
    s = torch.where(mx == 0, 0.0, diff / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], dim=-1)


def rgb_to_ycrcb(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + 0.5
    cb = (b - y) * 0.564 + 0.5
    return torch.stack([y, cr, cb], dim=-1)
