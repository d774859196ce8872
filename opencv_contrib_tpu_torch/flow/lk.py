"""Pyramidal Lucas-Kanade optical flow — the port of
opencv_contrib_tpu/flow/lk.py (cv::calcOpticalFlowPyrLK at the "local window
Gauss-Newton" level). Every window is sampled at once; the per-point 2x2
solve is closed form; the iterations are a Python loop."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.core import pyramid
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import sample_windows


def lk_level(I0, I1, pts_yx, flow0, radius: int = 7, iters: int = 10):
    """One-level LK: track points pts_yx (N, 2) from I0 to I1 starting at
    flow0 (N, 2) (dy, dx). Returns (flow (N, 2), valid (N,))."""
    gy, gx = filters.gradients(I0)
    T = sample_windows(I0, pts_yx, radius)  # template (N, M)
    Gy = sample_windows(gy, pts_yx, radius)
    Gx = sample_windows(gx, pts_yx, radius)
    # 2x2 structure tensor per point (template gradients, inverse-compositional)
    A11 = torch.sum(Gy * Gy, dim=1)
    A12 = torch.sum(Gy * Gx, dim=1)
    A22 = torch.sum(Gx * Gx, dim=1)
    det = A11 * A22 - A12 * A12
    ok = det > 1e-6
    det = torch.where(ok, det, 1.0)
    flow = flow0
    for _ in range(iters):
        r = sample_windows(I1, pts_yx, radius, flow_yx=flow) - T
        b1 = torch.sum(Gy * r, dim=1)
        b2 = torch.sum(Gx * r, dim=1)
        ddy = (A22 * b1 - A12 * b2) / det
        ddx = (A11 * b2 - A12 * b1) / det
        step = torch.where(ok[:, None], torch.stack([ddy, ddx], dim=1), 0.0)
        flow = flow - step
    H, W = I0.shape
    tgt_y = pts_yx[:, 0] + flow[:, 0]
    tgt_x = pts_yx[:, 1] + flow[:, 1]
    inb = (tgt_y >= 0) & (tgt_y <= H - 1) & (tgt_x >= 0) & (tgt_x <= W - 1)
    return flow, ok & inb


def track(I0, I1, pts_yx, levels: int = 3, radius: int = 7, iters: int = 10):
    """Pyramidal sparse LK: returns (new_pts (N, 2), flow (N, 2), valid)."""
    p0 = pyramid.build_pyramid(I0, levels)
    p1 = pyramid.build_pyramid(I1, levels)
    N = pts_yx.shape[0]
    flow = torch.zeros((N, 2), dtype=torch.float32, device=pts_yx.device)
    valid = torch.ones(N, dtype=torch.bool, device=pts_yx.device)
    for l in reversed(range(levels)):
        flow, v = lk_level(p0[l], p1[l], pts_yx * 0.5**l, flow, radius=radius, iters=iters)
        valid = valid & v
        if l > 0:
            flow = flow * 2.0
    return pts_yx + flow, flow, valid
