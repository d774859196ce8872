"""SEEDS and LSC superpixels (the port of
opencv_contrib_tpu/ximgproc/superpixels_x.py).

Reference anchors:
- SuperpixelSEEDS: ximgproc/src/seeds.cpp (block-based hill climbing on a
  color-histogram energy; pixel-level boundary refinement)
- SuperpixelLSC: ximgproc/src/lsc.cpp (linear spectral clustering: weighted
  k-means in a 10-d kernel feature space)

SEEDS' sequential exchanges are synchronous sweeps: every pixel proposes
its best neighbouring label against the current histograms, then the
histograms are rebuilt. Its histograms are integer counts, exact in any
order, so both devices give the JAX version's labels. LSC's centres are
`ops.segment.segment_sum`s, the same bits on a rerun on the card."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops.segment import segment_count, segment_sum


def _grid_labels(H: int, W: int, grid: int, device):
    """The regular grid's cell of each pixel, (gy, gx), each (H, W) int64:
    float32 iota over the float32 cell size, truncated, as the JAX version.
    The cell sizes are tensors: the card divides by a Python number as a
    product with its reciprocal, which can land a row on the cell below."""
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    ch, cw = (torch.full((), v, dtype=torch.float32, device=device) for v in (H / grid, W / grid))
    gy = torch.clamp((yy / ch).to(torch.int64), 0, grid - 1)
    gx = torch.clamp((xx / cw).to(torch.int64), 0, grid - 1)
    return gy, gx, yy, xx


def seeds(img: torch.Tensor, grid: int = 8, n_bins: int = 8, n_iters: int = 10) -> torch.Tensor:
    """SEEDS superpixels. img (H, W) or (H, W, C) in [0,1].
    Returns labels (H, W) int32 in [0, grid*grid)."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    K = grid * grid
    gy, gx, _, _ = _grid_labels(H, W, grid, img.device)
    labels = gy * grid + gx
    # the first channel's histogram (seeds.cpp's HistogramColor for gray inputs)
    q = torch.clamp((img[..., 0] * n_bins).to(torch.int64), 0, n_bins - 1)
    for _ in range(n_iters):
        h = segment_count((labels * n_bins + q).reshape(-1), K * n_bins).reshape(K, n_bins)
        hist = h / torch.clamp(h.sum(1, keepdim=True), min=1.0)
        p = F.pad(labels[None, None].to(torch.float32), (1, 1, 1, 1), mode="replicate")[0, 0].to(torch.int64)
        cand = torch.stack([labels, p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]])
        scores = hist[cand, q[None]]
        best = torch.argmax(scores, dim=0)
        labels = torch.gather(cand, 0, best[None])[0]
    return labels.to(torch.int32)


def lsc(img: torch.Tensor, grid: int = 8, ratio: float = 0.075, n_iters: int = 8):
    """LSC superpixels: weighted k-means in the 10-d kernel space
    phi(x) = (cos/sin of color channels, cos/sin of position) (lsc.cpp).
    Returns (labels (H, W) int32, centers (K, 10))."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None].expand(*img.shape, 3)
    H, W, _ = img.shape
    K = grid * grid
    S = (H / grid + W / grid) / 2.0
    gy, gx, yy, xx = _grid_labels(H, W, grid, img.device)
    hp = math.pi / 2.0
    Cc = 20.0  # color scale (reference's color_coeff relative form)
    Cs = ratio * Cc
    th_c = img * hp  # (H, W, 3) in [0, pi/2]
    th_y = yy / S * hp * 0.5
    th_x = xx / S * hp * 0.5
    feat = torch.cat([Cc * torch.cos(th_c), Cc * torch.sin(th_c),
                      (Cs * torch.cos(th_y))[..., None], (Cs * torch.sin(th_y))[..., None],
                      (Cs * torch.cos(th_x))[..., None], (Cs * torch.sin(th_x))[..., None]], dim=-1)  # (H, W, 10)
    flat_feat = feat.reshape(-1, 10)
    init_labels = gy * grid + gx

    def centers_of(labels):
        flat = labels.reshape(-1)
        cnt = segment_count(flat, K)
        return segment_sum(flat, flat_feat, K) / torch.clamp(cnt, min=1)[:, None]

    centers = centers_of(init_labels)
    best_k = init_labels
    for _ in range(n_iters):
        best_d = torch.full((H, W), float("inf"), device=img.device)
        best_k = init_labels
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                k = torch.clamp(gy + dy, 0, grid - 1) * grid + torch.clamp(gx + dx, 0, grid - 1)
                d = torch.sum((feat - centers[k]) ** 2, dim=-1)
                upd = d < best_d
                best_d = torch.where(upd, d, best_d)
                best_k = torch.where(upd, k, best_k)
        centers = centers_of(best_k)
    return best_k.to(torch.int32), centers
