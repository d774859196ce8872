"""Edge/line detection: gradient structured edges, Hough lines, thinning
(the port of opencv_contrib_tpu/ximgproc/edges.py).

The Hough accumulator counts every pixel's votes weighted by the edge mask
(the JAX version compacts the edge pixels first, with a static size): the
votes are small integers in float32, exact in any order, so the card's
accumulating scatter gives the same counts on every run. Thinning's
sub-iterations are whole-image boolean steps, 2 n_iters of them, with no
host sync."""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters


def _linspace(start: float, stop: float, num: int, endpoint: bool = True, device=None) -> torch.Tensor:
    """`jnp.linspace`'s formula in float32: start (1 - t) + stop t with
    t = iota / div, and the end point appended as it is. XLA's CPU rounding
    of it parts from this by an ulp or two of the values."""
    div = num - 1 if endpoint else num
    t = torch.arange(div, dtype=torch.float32, device=device) / torch.full((), float(div), device=device)
    out = start * (1 - t) + stop * t
    if endpoint:
        out = torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])
    return out


def _nms4(e: torch.Tensor, img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Zero the pixels of e that are not a maximum along their gradient
    direction (4 quantized directions; the neighbours wrap at the borders)."""
    gy, gx = filters.gradients(filters.gaussian_blur(img, sigma))
    ang = torch.atan2(gy, gx)
    q = torch.remainder(torch.round(ang / (math.pi / 4)).to(torch.int32), 4)
    nms = e
    for k, (dy, dx) in enumerate([(0, 1), (1, 1), (1, 0), (1, -1)]):
        n1 = torch.roll(e, (dy, dx), (0, 1))
        n2 = torch.roll(e, (-dy, -dx), (0, 1))
        keep = (e >= n1) & (e >= n2)
        nms = torch.where((q == k) & ~keep, 0.0, nms)
    return nms


def structured_edges_lite(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Edge probability map from multi-scale oriented gradients: the
    API/shape contract of StructuredEdgeDetection::detectEdges
    (structured_edge_detection.hpp:97), edges in [0,1], thinned along the
    gradient direction."""
    img = img.to(torch.float32)
    e = torch.zeros_like(img)
    for s in (sigma, 2 * sigma, 4 * sigma):
        gy, gx = filters.gradients(filters.gaussian_blur(img, s))
        e = e + torch.sqrt(gy * gy + gx * gx)
    e = e / 3.0
    e = e / torch.clamp(torch.max(e), min=1e-9)
    return _nms4(e, img, sigma)


def fast_hough_lines(edge_mask: torch.Tensor, n_angles: int = 180, n_rho: int = 256):
    """Hough transform accumulator (parity: FastHoughTransform /
    FastLineDetector's role): returns (accumulator (n_angles, n_rho),
    thetas, rhos)."""
    H, W = edge_mask.shape
    dev = edge_mask.device
    thetas = _linspace(0.0, math.pi, n_angles, endpoint=False, device=dev)
    diag_f = float(np.sqrt(np.float32(H * H + W * W)))
    diag = torch.full((), diag_f, device=dev)
    rhos = _linspace(-diag_f, diag_f, n_rho, device=dev)
    c = torch.cos(thetas)
    s = torch.sin(thetas)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W).reshape(-1)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W).reshape(-1)
    r = xs[:, None] * c[None] + ys[:, None] * s[None]  # (N, A)
    ri = torch.clamp(((r + diag) / (2 * diag) * n_rho).to(torch.int64), 0, n_rho - 1)
    slot = torch.arange(n_angles, device=dev)[None] * n_rho + ri
    votes = edge_mask.reshape(-1, 1).to(torch.float32).expand(-1, n_angles)
    acc = torch.zeros(n_angles * n_rho, device=dev).index_add_(0, slot.reshape(-1), votes.reshape(-1))
    return acc.reshape(n_angles, n_rho), thetas, rhos


def thinning(mask: torch.Tensor, n_iters: int = 20) -> torch.Tensor:
    """Morphological skeletonization (parity: cv::ximgproc::thinning,
    Zhang-Suen-class): iterative border deletion preserving connectivity,
    expressed with shifted-neighbor boolean logic."""
    b = mask.to(torch.bool)

    def subiter(b, phase):
        p2 = torch.roll(b, 1, 0)
        p3 = torch.roll(b, (1, -1), (0, 1))
        p4 = torch.roll(b, -1, 1)
        p5 = torch.roll(b, (-1, -1), (0, 1))
        p6 = torch.roll(b, -1, 0)
        p7 = torch.roll(b, (-1, 1), (0, 1))
        p8 = torch.roll(b, 1, 1)
        p9 = torch.roll(b, (1, 1), (0, 1))
        seq = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
        B = sum(p.to(torch.int32) for p in (p2, p3, p4, p5, p6, p7, p8, p9))
        A = sum(((~seq[i]) & seq[i + 1]).to(torch.int32) for i in range(8))
        cond = (B >= 2) & (B <= 6) & (A == 1)
        if phase == 0:
            cond = cond & ~(p2 & p4 & p6) & ~(p4 & p6 & p8)
        else:
            cond = cond & ~(p2 & p4 & p8) & ~(p2 & p6 & p8)
        return b & ~cond

    for _ in range(n_iters):
        b = subiter(subiter(b, 0), 1)
    return b
