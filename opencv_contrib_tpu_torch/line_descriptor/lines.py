"""Line segment detection and LBD-class band descriptors (the port of
opencv_contrib_tpu/line_descriptor/lines.py).

The Hough votes are integers, so peaks tie often: the twin's `lax.top_k`
breaks ties by the lower index, and so does the stable descending sort
here (`torch.topk` promises no order among ties). The accumulator's 5x5
maximum is `ops.morphology`'s window maximum, padded as `lax.reduce_window`
pads "SAME"."""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.ops.morphology import _window_max
from opencv_contrib_tpu_torch.utils.device import as_float
from opencv_contrib_tpu_torch.ximgproc.edges import _linspace, fast_hough_lines


def _stable_top(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of x (1-D), ties by the lower index (`lax.top_k`)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def detect_line_segments(img, max_lines: int = 16, edge_thresh: float = 0.2, min_support: int = 20):
    """Detect straight line segments: edge map -> Hough peaks -> segment
    endpoints from the extent of on-line edge support.

    Returns (segments (max_lines, 4) [y0, x0, y1, x1], valid (max_lines,))."""
    img = as_float(img)
    gy, gx = filters.gradients(filters.gaussian_blur(img, 1.0))
    mag = torch.sqrt(gy * gy + gx * gx)
    edges = mag > edge_thresh * torch.clamp(mag.max(), min=1e-9)
    acc, thetas, rhos = fast_hough_lines(edges)
    A, Rn = acc.shape
    mx = _window_max(acc, 5)
    peaks = torch.where((acc >= mx) & (acc >= min_support), acc, -math.inf).reshape(-1)
    top = _stable_top(peaks, max_lines)
    valid = peaks[top] > 0
    theta = thetas[top // Rn]
    rho = rhos[top % Rn]

    # the support extent of each line: positions along it
    H, W = img.shape
    L = int(np.hypot(H, W))
    s = _linspace(-L / 2, L / 2, 2 * L, device=img.device)
    c, sn = torch.cos(theta), torch.sin(theta)
    # a point on the line: (x0, y0) = rho (c, s); direction (-s, c)
    cx = rho * c
    cy = rho * sn
    px = cx[:, None] - sn[:, None] * s[None]
    py = cy[:, None] + c[:, None] * s[None]
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    on_edge = sample_bilinear(edges.to(torch.float32), py, px) > 0.3
    sup = inb & on_edge
    n_s = s.shape[0]
    idx = torch.arange(n_s, device=img.device)
    first = torch.where(sup, idx[None], n_s).amin(dim=1)
    last = torch.where(sup, idx[None], -1).amax(dim=1)
    ok = valid & (last > first)
    f = torch.clamp(first, 0, n_s - 1)
    l = torch.clamp(last, 0, n_s - 1)  # noqa: E741
    y0 = cy + c * s[f]
    x0 = cx - sn * s[f]
    y1 = cy + c * s[l]
    x1 = cx - sn * s[l]
    segs = torch.stack([y0, x0, y1, x1], dim=1)
    return segs * ok[:, None], ok


def lbd_describe(img, segments: torch.Tensor, valid: torch.Tensor, n_bands: int = 9, band_width: int = 3,
                 n_samples: int = 32) -> torch.Tensor:
    """Line Band Descriptor: for each segment, gradient statistics sampled in
    n_bands bands parallel to the line -> (L, n_bands * 4) float descriptor,
    L2-normalized (BinaryDescriptor's LBD float stage)."""
    img = as_float(img)
    gy, gx = filters.gradients(filters.gaussian_blur(img, 1.0))
    y0, x0, y1, x1 = segments[:, 0], segments[:, 1], segments[:, 2], segments[:, 3]
    dy = y1 - y0
    dx = x1 - x0
    length = torch.sqrt(dy * dy + dx * dx) + 1e-9
    uy, ux = dy / length, dx / length  # along the line
    ny, nx = -ux, uy  # normal

    t = _linspace(0.0, 1.0, n_samples, device=img.device)
    feats = []
    for b in range(n_bands):
        off = (b - (n_bands - 1) / 2.0) * band_width
        sy = y0[:, None] + dy[:, None] * t[None] + ny[:, None] * off
        sx = x0[:, None] + dx[:, None] * t[None] + nx[:, None] * off
        g1 = sample_bilinear(gy, sy, sx)
        g2 = sample_bilinear(gx, sy, sx)
        # the gradients in the line's frame
        g_par = g1 * uy[:, None] + g2 * ux[:, None]
        g_perp = g1 * ny[:, None] + g2 * nx[:, None]
        feats += [
            torch.mean(torch.clamp(g_perp, min=0), dim=1),
            torch.mean(torch.clamp(-g_perp, min=0), dim=1),
            torch.mean(torch.clamp(g_par, min=0), dim=1),
            torch.mean(torch.clamp(-g_par, min=0), dim=1),
        ]
    d = torch.stack(feats, dim=1)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-9)
    return d * valid[:, None]
