"""Separable filters and gradients (the port of the frontend's part of
opencv_contrib_tpu/ops/filters.py). Separable filters are shift-adds over a
reflect-padded image (BORDER_REFLECT_101), as in the JAX version."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _reflect_pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    return F.pad(img[None, None], (left, right, top, bottom), mode="reflect")[0, 0]


def sep_filter2d(img: torch.Tensor, kr: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """Separable filter: row kernel kr (vertical), column kernel kc
    (horizontal); correlation orientation, reflect border. img (H, W[, C])."""
    if img.ndim == 3:  # (H, W, C): per channel
        return torch.stack([sep_filter2d(img[..., c], kr, kc) for c in range(img.shape[-1])], dim=-1)
    H, W = img.shape
    nr, nc = kr.shape[0], kc.shape[0]
    rr = (nr - 1) // 2
    rc = (nc - 1) // 2
    out = img
    if nr > 1:
        p = _reflect_pad(out, rr, nr - 1 - rr, 0, 0)
        acc = kr[0] * p[0:H, :]
        for i in range(1, nr):
            acc = acc + kr[i] * p[i:i + H, :]
        out = acc
    else:
        out = out * kr[0]
    if nc > 1:
        p = _reflect_pad(out, 0, 0, rc, nc - 1 - rc)
        acc = kc[0] * p[:, 0:W]
        for i in range(1, nc):
            acc = acc + kc[i] * p[:, i:i + W]
        out = acc
    else:
        out = out * kc[0]
    return out


def gaussian_kernel1d(sigma: float, radius: int | None = None, device="cpu") -> torch.Tensor:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    k = gaussian_kernel1d(sigma, radius, device=img.device)
    return sep_filter2d(img, k, k)


def gradients(img: torch.Tensor):
    """Central-difference image gradients (gy, gx), replicate-edge borders."""
    gy = (torch.roll(img, -1, 0) - torch.roll(img, 1, 0)) * 0.5
    gx = (torch.roll(img, -1, 1) - torch.roll(img, 1, 1)) * 0.5
    gy[0] = img[1] - img[0]
    gy[-1] = img[-1] - img[-2]
    gx[:, 0] = img[:, 1] - img[:, 0]
    gx[:, -1] = img[:, -1] - img[:, -2]
    return gy, gx
