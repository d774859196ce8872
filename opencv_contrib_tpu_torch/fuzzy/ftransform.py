"""F0- and F1-transforms with triangular basis functions (the port of
opencv_contrib_tpu/fuzzy/ftransform.py).

The F0 transform computes weighted local means over an overlapping
triangular partition (stride = radius); the inverse reconstructs by basis-
weighted interpolation — together they act as the reference's ft02D_process
smoothing, and masking enables inpainting. The cell sums are products with
the (C, n) basis matrices, in full float32. Inputs are tensors (host data
runs on the CPU).
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.utils.device import as_float
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


def _basis_1d(n: int, radius: int, device=None) -> torch.Tensor:
    """Triangular partition centers + weights: centers every `radius` px."""
    centers = torch.arange(0, n + radius - 1, radius, device=device)
    x = torch.arange(n, device=device)
    d = torch.abs(x[None, :] - centers[:, None]).to(torch.float32)
    return torch.clamp(1.0 - d / torch.full((), float(radius), device=device), min=0.0)  # (C, n)


def _cell_sum(fy, v, fx):
    """einsum("ch,hw,dw->cd")."""
    return (fy @ v) @ fx.T


def _spread(comp, fy, fx):
    """einsum("cd,ch,dw->hw")."""
    return fy.T @ (comp @ fx)


def _mask(img, mask):
    return torch.ones_like(img) if mask is None else torch.as_tensor(mask, device=img.device).to(img.dtype)


@f32_matmuls
def f0_components(img, radius: int = 8, mask=None):
    """F0 components (Cy, Cx) over the partition; mask=True marks valid
    pixels (invalid ones excluded, enabling inpainting). Returns
    (components, denominators)."""
    img = as_float(img)
    H, W = img.shape
    wy = _basis_1d(H, radius, img.device)  # (Cy, H)
    wx = _basis_1d(W, radius, img.device)  # (Cx, W)
    m = _mask(img, mask)
    num = _cell_sum(wy, img * m, wx)
    den = _cell_sum(wy, m, wx)
    return num / torch.clamp(den, min=1e-9), den


@f32_matmuls
def f0_inverse(components, shape, radius: int = 8) -> torch.Tensor:
    components = as_float(components)
    H, W = shape
    wy = _basis_1d(H, radius, components.device)
    wx = _basis_1d(W, radius, components.device)
    num = _spread(components, wy, wx)
    den = wy.sum(0)[:, None] * wx.sum(0)[None, :]
    return num / torch.clamp(den, min=1e-9)


def f0_filter(img, radius: int = 8) -> torch.Tensor:
    """FT-based smoothing filter (ft::filter contract)."""
    img = as_float(img)
    comp, _ = f0_components(img, radius)
    return f0_inverse(comp, img.shape, radius)


def f0_inpaint(img, mask, radius: int = 8) -> torch.Tensor:
    """FT-based inpainting: components from valid pixels only; masked
    pixels reconstructed from the inverse transform (ft::inpaint ONE_STEP)."""
    img = as_float(img)
    mask = torch.as_tensor(mask, device=img.device).to(torch.bool)
    comp, _ = f0_components(img, radius, mask=~mask)
    recon = f0_inverse(comp, img.shape, radius)
    return torch.where(mask, recon, img)


def _centroid_offsets(w, n, device):
    """Each cell's offsets from its basis CENTROID (for border cells the
    clipped triangle's centroid is off the nominal center; using it keeps
    linear functions exactly representable): (C, n)."""
    xs = torch.arange(n, dtype=torch.float32, device=device)
    c = (w @ xs) / torch.clamp(w.sum(1), min=1e-9)
    return xs[None, :] - c[:, None]


@f32_matmuls
def f1_components(img, radius: int = 8, mask=None):
    """F1-transform components: per-cell linear model c00 + cy*(y-yc) +
    cx*(x-xc) fitted under the triangular weights (fuzzy/src/fuzzy_F1_math.cpp
    F1transform semantics). Returns (c00, c10_y, c01_x) each (Cy, Cx)."""
    img = as_float(img)
    H, W = img.shape
    dev = img.device
    wy = _basis_1d(H, radius, dev)  # (Cy, H)
    wx = _basis_1d(W, radius, dev)  # (Cx, W)
    m = _mask(img, mask)
    dy = _centroid_offsets(wy, H, dev)
    dx = _centroid_offsets(wx, W, dev)
    den0 = _cell_sum(wy, m, wx)
    c00 = _cell_sum(wy, img * m, wx) / torch.clamp(den0, min=1e-9)
    deny = _cell_sum(wy * dy * dy, m, wx)
    c10 = _cell_sum(wy * dy, img * m, wx) / torch.clamp(deny, min=1e-9)
    denx = _cell_sum(wy, m, wx * dx * dx)
    c01 = _cell_sum(wy, img * m, wx * dx) / torch.clamp(denx, min=1e-9)
    # orthogonality correction: remove the mean captured by c00
    c10 = c10 - _cell_sum(wy * dy, m, wx) * c00 / torch.clamp(deny, min=1e-9)
    c01 = c01 - _cell_sum(wy, m, wx * dx) * c00 / torch.clamp(denx, min=1e-9)
    return c00, c10, c01


@f32_matmuls
def f1_inverse(c00, c10, c01, shape, radius: int = 8) -> torch.Tensor:
    """Inverse F1-transform: basis-weighted linear reconstruction."""
    c00, c10, c01 = as_float(c00), as_float(c10), as_float(c01)
    H, W = shape
    dev = c00.device
    wy = _basis_1d(H, radius, dev)
    wx = _basis_1d(W, radius, dev)
    dy = _centroid_offsets(wy, H, dev)
    dx = _centroid_offsets(wx, W, dev)
    num = _spread(c00, wy, wx) + _spread(c10, wy * dy, wx) + _spread(c01, wy, wx * dx)
    den = wy.sum(0)[:, None] * wx.sum(0)[None, :]
    return num / torch.clamp(den, min=1e-9)


def f1_filter(img, radius: int = 8) -> torch.Tensor:
    """F1 smoothing: forward + inverse (keeps local gradients, unlike F0)."""
    img = as_float(img)
    c00, c10, c01 = f1_components(img, radius)
    return f1_inverse(c00, c10, c01, img.shape, radius)
