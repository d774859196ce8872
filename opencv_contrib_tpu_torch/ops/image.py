"""Sampling, windows, resizing and affine warps (the port of
opencv_contrib_tpu/ops/image.py). Border: clamp (BORDER_REPLICATE)."""

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


def sample_windows(img: torch.Tensor, pts_yx: torch.Tensor, radius: int,
                   flow_yx: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear-sample the (2r+1)^2 integer-offset window around each float
    center: out[n, m] = img(pts[n] (+ flow[n]) + offs[m]), (N, (2r+1)^2),
    offsets row-major (dy outer).

    The offsets are integers, so one fraction (fy, fx) serves a whole
    window. The four corners are gathered directly (the JAX version's
    one-hot selection dot is a TPU device). Border rule, as in the JAX
    version: a window row's index is clipped to the image first and its
    lower neighbour is min(row + 1, H - 1) (columns alike), so a row at
    y0 + o = -1 blends rows 0 and 1, not 0 and 0 as `sample_bilinear` does."""
    H, W = img.shape
    py, px = pts_yx[:, 0], pts_yx[:, 1]
    if flow_yx is not None:
        py, px = py + flow_yx[:, 0], px + flow_yx[:, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    fy = (py - y0)[:, None, None]
    fx = (px - x0)[:, None, None]
    offs = torch.arange(-radius, radius + 1, device=img.device)
    ry0 = torch.clamp(y0.long()[:, None] + offs, 0, H - 1)  # (N, M)
    ry1 = torch.clamp(ry0 + 1, max=H - 1)
    cx0 = torch.clamp(x0.long()[:, None] + offs, 0, W - 1)
    cx1 = torch.clamp(cx0 + 1, max=W - 1)
    flat = img.reshape(-1)

    def rows_at(cx):  # the y blend at window columns cx: (N, M, M)
        top = flat[(ry0 * W)[:, :, None] + cx[:, None, :]]
        bot = flat[(ry1 * W)[:, :, None] + cx[:, None, :]]
        return top * (1.0 - fy) + bot * fy

    out = rows_at(cx0) * (1.0 - fx) + rows_at(cx1) * fx
    return out.reshape(pts_yx.shape[0], -1)


def grid_coords(H: int, W: int, device=None, dtype=torch.float32):
    """Pixel-center coordinate grids (y, x), each (H, W)."""
    y = torch.arange(H, dtype=dtype, device=device)[:, None].expand(H, W)
    x = torch.arange(W, dtype=dtype, device=device)[None, :].expand(H, W)
    return y, x


def _resize_matrix(n_out: int, n_in: int, method: str, device=None) -> torch.Tensor:
    """(n_out, n_in) 1D interpolation operator (pixel-center aligned,
    clamped borders). Two-tap rows for 'linear', one-tap for 'nearest'."""
    s = n_in / n_out
    ys = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * s - 0.5
    cols = torch.arange(n_in, dtype=torch.float32, device=device)[None, :]
    if method == "nearest":
        yi = torch.clamp(torch.round(ys), 0, n_in - 1)[:, None]
        return (cols == yi).to(torch.float32)
    y0 = torch.floor(ys)
    f = (ys - y0)[:, None]
    y0c = torch.clamp(y0, 0, n_in - 1)[:, None]
    y1c = torch.clamp(y0 + 1, 0, n_in - 1)[:, None]
    return ((cols == y0c) * (1.0 - f) + (cols == y1c) * f).to(torch.float32)


def resize(img: torch.Tensor, out_hw, method: str = "linear") -> torch.Tensor:
    """Resize (H, W[, C]) to out_hw: 'linear' | 'nearest' | 'area'. The
    separable form out = My @ img @ Mx^T with 1- or 2-tap interpolation
    matrices (full f32 products where the caller pins them)."""
    Ho, Wo = out_hw
    H, W = img.shape[0], img.shape[1]
    if (Ho, Wo) == (H, W):
        return img
    if method == "area" and H % Ho == 0 and W % Wo == 0:
        fy, fx = H // Ho, W // Wo
        return img.reshape((Ho, fy, Wo, fx) + tuple(img.shape[2:])).mean(dim=(1, 3))
    My = _resize_matrix(Ho, H, method, img.device)
    Mx = _resize_matrix(Wo, W, method, img.device)
    img = img.to(torch.float32)
    if img.ndim == 2:
        return (My @ img) @ Mx.T
    C = img.shape[2]
    rows = (My @ img.reshape(H, W * C)).reshape(Ho, W, C)
    return torch.einsum("hwc,ow->hoc", rows, Mx)


def warp_affine(img: torch.Tensor, M, out_hw=None) -> torch.Tensor:
    """Inverse-warp with a 2x3 affine matrix mapping OUTPUT -> INPUT coords
    (cv::warpAffine's WARP_INVERSE_MAP matrix)."""
    M = torch.as_tensor(M, dtype=torch.float32, device=img.device)
    if out_hw is None:
        out_hw = img.shape[:2]
    y, x = grid_coords(*out_hw, device=img.device)
    xs = M[0, 0] * x + M[0, 1] * y + M[0, 2]
    ys = M[1, 0] * x + M[1, 1] * y + M[1, 2]
    return sample_bilinear(img, ys, xs)
