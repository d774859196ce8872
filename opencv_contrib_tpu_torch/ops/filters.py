"""Separable filters, gradients, the bilateral and the 3x3 median filter
(the port of the parts of opencv_contrib_tpu/ops/filters.py the frontend,
KinectFusion and dense flow use). Separable filters are shift-adds over a reflect-padded image
(BORDER_REFLECT_101), as in the JAX version."""

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


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    n = 2 * radius + 1
    k = torch.full((n,), 1.0 / n, dtype=torch.float32, device=img.device)
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


def bilateral_filter(img: torch.Tensor, sigma_space: float = 2.0, sigma_color: float = 0.1,
                     radius: int = 4) -> torch.Tensor:
    """Edge-preserving bilateral filter on (H, W): the depth smoothing of the
    KinFu frame builder. A shift-and-accumulate over the (2r+1)^2 window,
    dy outer and dx inner as in the JAX version; the shifts WRAP at the
    borders (`torch.roll`, as `jnp.roll`), and zero (invalid) pixels are
    excluded as neighbours and stay zero."""
    img = img.to(torch.float32)
    valid = img > 0
    validf = valid.to(torch.float32)
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    inv2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    inv2sc = 1.0 / (2.0 * sigma_color * sigma_color)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(img, (dy, dx), dims=(0, 1))
            svalid = torch.roll(validf, (dy, dx), dims=(0, 1))
            wspace = math.exp(-(dy * dy + dx * dx) * inv2ss)
            diff = shifted - img
            w = wspace * torch.exp(-(diff * diff) * inv2sc) * svalid
            num = num + w * shifted
            den = den + w
    out = num / torch.clamp(den, min=1e-12)
    return torch.where(valid, out, 0.0)


def median_filter3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median over 9 shifted copies; the shifts WRAP at the borders, as
    the JAX version's `jnp.roll` stack. The median of 9 is the middle one."""
    stack = torch.stack([torch.roll(img, (dy, dx), dims=(0, 1)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    return torch.median(stack, dim=0).values
