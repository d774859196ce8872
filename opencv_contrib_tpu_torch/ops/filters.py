"""Separable filters, gradients, depthwise 2D correlation, the bilateral,
guided and 3x3 median filters (the port of the parts of
opencv_contrib_tpu/ops/filters.py the frontend, KinectFusion, dense flow and
the photometric / quality path use). Separable filters are shift-adds over a
reflect-padded image (BORDER_REFLECT_101), as in the JAX version."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def reflect_index(n: int, before: int, after: int, device=None) -> torch.Tensor:
    """The source index of each position -before .. n + after - 1 of a side
    of n >= 1 padded by BORDER_REFLECT_101 (`jnp.pad(mode="reflect")`) at
    any pad: the index folded with period 2 (n - 1); a side of 1 repeats
    its value."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * (n - 1)
    i = torch.remainder(i, p)
    return torch.where(i >= n, p - i, i)


def reflect_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """x (H, W), (C, H, W) or (N, C, H, W) padded along its last two axes by
    BORDER_REFLECT_101 at any pad, as `jnp.pad(mode="reflect")` pads:
    `F.pad` where every pad is smaller than its side (it refuses the rest),
    else a gather of the folded indices. Both copy values, so both give the
    same bits."""
    H, W = x.shape[-2:]
    if max(top, bottom) < H and max(left, right) < W:
        pads = (left, right, top, bottom)
        return F.pad(x[None, None], pads, mode="reflect")[0, 0] if x.ndim == 2 else F.pad(x, pads, mode="reflect")
    rows = reflect_index(H, top, bottom, x.device)
    cols = reflect_index(W, left, right, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


_PAD_MODES = {"reflect": "reflect", "edge": "replicate", "zero": "constant"}


def conv2d(img: torch.Tensor, kernel, border: str = "reflect") -> torch.Tensor:
    """Depthwise 2D correlation of (H, W[, C]) with (kh, kw): `F.conv2d`
    with one group per channel, on the image padded by `border`: 'reflect'
    (BORDER_REFLECT_101, OpenCV's default), 'edge' (BORDER_REPLICATE) or
    'zero' (BORDER_CONSTANT 0). Full float32 products on the card need
    `utils.precision.f32_matmuls` (cuDNN takes TF32 by default)."""
    if border not in _PAD_MODES:
        raise ValueError(f"conv2d: border must be one of {sorted(_PAD_MODES)}, got {border!r}")
    k = torch.as_tensor(kernel, dtype=torch.float32, device=img.device)
    kh, kw = k.shape
    x = img.to(torch.float32)
    x = x[None, None] if x.ndim == 2 else torch.movedim(x, -1, 0)[None]
    C = x.shape[1]
    pads = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
    if border == "reflect":
        x = reflect_pad(x, pads[2], pads[3], pads[0], pads[1])
    else:
        x = F.pad(x, pads, mode=_PAD_MODES[border])
    y = F.conv2d(x, k.expand(C, 1, kh, kw), groups=C)[0]
    return y[0] if img.ndim == 2 else torch.movedim(y, 0, -1)


def sep_filter2d(img: torch.Tensor, kr: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """Separable filter: row kernel kr (vertical), column kernel kc
    (horizontal); correlation orientation, reflect border at any size (a
    kernel may reach past a small image's side). img (H, W[, C])."""
    if img.ndim == 3:  # (H, W, C): per channel
        return torch.stack([sep_filter2d(img[..., c], kr, kc) for c in range(img.shape[-1])], dim=-1)
    H, W = img.shape
    nr, nc = kr.shape[0], kc.shape[0]
    rr = (nr - 1) // 2
    rc = (nc - 1) // 2
    out = img
    if nr > 1:
        p = reflect_pad(out, rr, nr - 1 - rr, 0, 0)
        acc = kr[0] * p[0:H, :]
        for i in range(1, nr):
            acc = acc + kr[i] * p[i:i + H, :]
        out = acc
    else:
        out = out * kr[0]
    if nc > 1:
        p = reflect_pad(out, 0, 0, rc, nc - 1 - rc)
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


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int, eps: float) -> torch.Tensor:
    """He et al. guided filter with a grayscale guide, O(1) in the radius
    through box filters (ximgproc GuidedFilter)."""
    I = guide.to(torch.float32)
    p = src.to(torch.float32)
    mean_I = box_filter(I, radius)
    mean_p = box_filter(p, radius)
    corr_Ip = box_filter(I * p, radius)
    corr_II = box_filter(I * I, radius)
    var_I = corr_II - mean_I * mean_I
    cov_Ip = corr_Ip - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    return box_filter(a, radius) * I + box_filter(b, radius)


SOBEL_D = (-1.0, 0.0, 1.0)
SOBEL_S = (1.0, 2.0, 1.0)


def sobel(img: torch.Tensor, dx: int = 1, dy: int = 0) -> torch.Tensor:
    """Sobel derivative (OpenCV kernel; dx, dy in {0, 1}, ksize 3), reflect
    border. The taps stay host tensors: sep_filter2d reads them as scalars."""
    kr = torch.tensor(SOBEL_D if dy else SOBEL_S)
    kc = torch.tensor(SOBEL_D if dx else SOBEL_S)
    return sep_filter2d(img, kr, kc)


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
