"""Bilinear sampling (the port of opencv_contrib_tpu/ops/image.py's
samplers). Border: clamp (BORDER_REPLICATE)."""

from __future__ import annotations

import torch


def _gather2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img (H, W) or (H, W, C); integer index tensors of one shape S ->
    values (S) or (S, C). Indices are clipped to the image."""
    H, W = img.shape[0], img.shape[1]
    yi = torch.clamp(yi, 0, H - 1).long()
    xi = torch.clamp(xi, 0, W - 1).long()
    flat = img.reshape((H * W,) + tuple(img.shape[2:]))
    return flat[yi * W + xi]


def sample_bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img (H, W[, C]) at float coords y, x (any shape)."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[..., None] if img.ndim == 3 else (y - y0)
    wx = (x - x0)[..., None] if img.ndim == 3 else (x - x0)
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    v00 = _gather2d(img, y0i, x0i)
    v01 = _gather2d(img, y0i, x0i + 1)
    v10 = _gather2d(img, y0i + 1, x0i)
    v11 = _gather2d(img, y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def sample_bilinear_multi(maps: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample C maps (C, H, W) at shared float coords with one
    gather: the 4 corners of all C maps are stacked into (H*W, 4C) rows
    (the bottom and right neighbours wrap, as in the JAX version; the clamp
    to H-1.001 / W-1.001 keeps the wrapped corners at zero weight).
    Returns (C, *y.shape)."""
    C, H, W = maps.shape
    m01 = torch.roll(maps, -1, 2)
    m10 = torch.roll(maps, -1, 1)
    m11 = torch.roll(m10, -1, 2)
    T = torch.cat([maps, m01, m10, m11], dim=0).reshape(4 * C, -1).T  # (H*W, 4C)
    yc = torch.clamp(y, 0.0, H - 1.001)
    xc = torch.clamp(x, 0.0, W - 1.001)
    y0 = torch.floor(yc).to(torch.int64)
    x0 = torch.floor(xc).to(torch.int64)
    fy = yc - y0
    fx = xc - x0
    rows = T[y0 * W + x0]  # (*y.shape, 4C)
    w = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx])  # (4, ...)
    r = torch.movedim(rows, -1, 0).reshape((4, C) + tuple(y.shape))
    return (r * w[:, None]).sum(0)
