"""Integral images and box sums (the port of opencv_contrib_tpu/ops/integral.py).

`integral` is the zero-padded (H+1, W+1) table of cv::integral. Its 2D
prefix sum is `ops.cuda.scan.integral_image`: the scan kernel on a CUDA
tensor, two `torch.cumsum`s on a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops.cuda.scan import integral_image
from opencv_contrib_tpu_torch.ops.image import _gather2d


def integral(img: torch.Tensor) -> torch.Tensor:
    """Summed-area table with one row/col of zero padding: out (H+1, W+1),
    out[i, j] = sum(img[:i, :j])."""
    return F.pad(integral_image(img.to(torch.float32)), (1, 0, 1, 0))


def box_sum(ii: torch.Tensor, y0, x0, h, w) -> torch.Tensor:
    """Sum over img[y0:y0+h, x0:x0+w] from ii (H+1, W+1); indices clipped."""
    y0 = torch.as_tensor(y0, dtype=torch.int64, device=ii.device)
    x0 = torch.as_tensor(x0, dtype=torch.int64, device=ii.device)
    y1 = y0 + h
    x1 = x0 + w
    a = _gather2d(ii, y0, x0)
    b = _gather2d(ii, y0, x1)
    c = _gather2d(ii, y1, x0)
    d = _gather2d(ii, y1, x1)
    return d - b - c + a


def box_mean(ii: torch.Tensor, y0, x0, h, w) -> torch.Tensor:
    return box_sum(ii, y0, x0, h, w) / (h * w)


def haar_x(ii: torch.Tensor, yc, xc, size) -> torch.Tensor:
    """Horizontal Haar response of width `size` centred at (yc, xc): right
    half minus left half."""
    half = size // 2
    y0 = yc - half
    left = box_sum(ii, y0, xc - half, size, half)
    right = box_sum(ii, y0, xc, size, half)
    return right - left


def haar_y(ii: torch.Tensor, yc, xc, size) -> torch.Tensor:
    half = size // 2
    x0 = xc - half
    top = box_sum(ii, yc - half, x0, half, size)
    bot = box_sum(ii, yc, x0, half, size)
    return bot - top
