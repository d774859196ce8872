"""SLIC superpixels (the port of opencv_contrib_tpu/ximgproc/slic.py;
parity: cv::ximgproc::SuperpixelSLIC, slic.hpp:78).

Each iteration assigns every pixel to the best of its 9 neighbouring
cluster seeds and recomputes the centres by a segment sum, all batched. The
9 candidate seeds of a pixel are a function of its grid cell, so each
candidate's (y, x, colour) maps are an edge-clamped shift of the (grid,
grid) seed tables, upsampled by block repetition: copies, no gathers. The
centres are `ops.segment.segment_sum`s (a one-hot product on the card, as
the JAX version's one-hot dot), so a rerun gives the same bits."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops.segment import segment_sum


def _shift_clamp(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped shift of a (g, g, ...) table by (dy, dx)."""
    g = m.shape[0]
    rows = torch.clamp(torch.arange(g, device=m.device) + dy, 0, g - 1)
    cols = torch.clamp(torch.arange(g, device=m.device) + dx, 0, g - 1)
    return m.index_select(0, rows).index_select(1, cols)


def slic(img: torch.Tensor, grid: int = 8, compactness: float = 10.0, n_iters: int = 8):
    """img (H, W) or (H, W, C) in [0,1]; grid x grid superpixels.

    Returns (labels (H, W) int32 in [0, grid*grid), centers (grid*grid, 2))."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None]
    H0, W0, C = img.shape
    dev = img.device
    # pad to grid multiples so cells tile exactly (labels cropped at the end)
    ph, pw = (-H0) % grid, (-W0) % grid
    if ph or pw:
        img = F.pad(img.permute(2, 0, 1)[None], (0, pw, 0, ph), mode="replicate")[0].permute(1, 2, 0)
    H, W, _ = img.shape
    Hg, Wg = H // grid, W // grid
    S = (H / grid + W / grid) / 2.0  # nominal spacing
    K = grid * grid

    cy = (torch.arange(grid, device=dev, dtype=torch.float32) + 0.5) * Hg
    cx = (torch.arange(grid, device=dev, dtype=torch.float32) + 0.5) * Wg
    sy = cy.repeat_interleave(grid)
    sx = cx.repeat(grid)
    sc = img[torch.clamp(sy.to(torch.int64), 0, H - 1), torch.clamp(sx.to(torch.int64), 0, W - 1)]

    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    m2 = (compactness / S) ** 2
    kbase = torch.arange(K, dtype=torch.int32, device=dev).reshape(grid, grid)
    feats = torch.cat([torch.ones((H * W, 1), device=dev), y.reshape(-1, 1), x.reshape(-1, 1),
                       img.reshape(-1, C)], dim=1)  # (N, 3 + C)

    def up(m):
        return m.repeat_interleave(Hg, 0).repeat_interleave(Wg, 1)

    best_k = None
    for _ in range(n_iters):
        sym = sy.reshape(grid, grid)
        sxm = sx.reshape(grid, grid)
        scm = sc.reshape(grid, grid, C)
        best_d = torch.full((H, W), float("inf"), device=dev)
        best_k = torch.zeros((H, W), dtype=torch.int32, device=dev)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                kU = up(_shift_clamp(kbase, dy, dx))
                scU = up(_shift_clamp(scm, dy, dx))
                syU = up(_shift_clamp(sym, dy, dx))
                sxU = up(_shift_clamp(sxm, dy, dx))
                dc = torch.sum((img - scU) ** 2, dim=-1)
                ds = (y - syU) ** 2 + (x - sxU) ** 2
                d = dc + m2 * ds
                upd = d < best_d
                best_d = torch.where(upd, d, best_d)
                best_k = torch.where(upd, kU, best_k)
        sums = segment_sum(best_k.reshape(-1), feats, K)  # (K, 3 + C)
        cnt = sums[:, 0]
        denom = torch.clamp(cnt, min=1.0)
        sy = torch.where(cnt > 0, sums[:, 1] / denom, sy)
        sx = torch.where(cnt > 0, sums[:, 2] / denom, sx)
        sc = torch.where((cnt > 0)[:, None], sums[:, 3:] / denom[:, None], sc)
    labels = best_k[:H0, :W0]
    return labels, torch.stack([sy, sx], dim=1)
