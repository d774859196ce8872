"""DIS-class dense optical flow — the port of opencv_contrib_tpu/flow/dis.py:
coarse-to-fine patch inverse search, patch-flow densification and
variational refinement (DIS, Kroeger et al.; cv::VariationalRefinement).

Per level: (1) a grid of overlapping patches, refined together by one
`lk.lk_level` call; (2) densification, a box-filtered blend of the patch
flows weighted by their residuals; (3) fixed Jacobi sweeps of the
linearised brightness-constancy + smoothness system. The warp of (3)
samples I1 and its gradients at the flow with one remap launch (C = 3)."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.core import pyramid
from opencv_contrib_tpu_torch.flow import lk
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.cuda import remap
from opencv_contrib_tpu_torch.ops.image import resize, sample_bilinear, sample_windows


def _centers(n: int, stride: int, device=None) -> torch.Tensor:
    return torch.arange(stride // 2, n - stride // 2, stride, dtype=torch.float32, device=device)


def _patch_grid(H: int, W: int, stride: int, device=None) -> torch.Tensor:
    gy, gx = torch.meshgrid(_centers(H, stride, device), _centers(W, stride, device), indexing="ij")
    return torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=1)


def _level_patch_flow(I0, I1, flow_init, stride: int, radius: int, iters: int):
    """Inverse-search patch refinement + densification on one level.
    flow_init: (H, W, 2) upscaled flow from the coarser level. Returns the
    dense (H, W, 2)."""
    H, W = I0.shape
    dev = I0.device
    pts = _patch_grid(H, W, stride, dev)  # (P, 2)
    f0 = sample_bilinear(flow_init, pts[:, 0], pts[:, 1])  # (P, 2)
    flow_p, valid = lk.lk_level(I0, I1, pts, f0, radius=radius, iters=iters)
    # patch residual -> weight (DIS uses the inverse mean abs diff)
    T = sample_windows(I0, pts, radius)
    Iw = sample_windows(I1, pts, radius, flow_yx=flow_p)
    res = torch.mean(torch.abs(Iw - T), dim=1)
    w = torch.where(valid, 1.0 / (res + 1e-2), 1e-6)
    flow_p = torch.where(valid[:, None], flow_p, f0)

    # densification: each pixel takes its nearest patch cell, then a box
    # blur over the patch footprint blends the overlapping patches
    Hp, Wp = len(_centers(H, stride)), len(_centers(W, stride))
    fmap = flow_p.reshape(Hp, Wp, 2)
    wmap = w.reshape(Hp, Wp, 1)
    fy = torch.clamp(torch.div(torch.arange(H, device=dev) - stride // 2, stride, rounding_mode="floor"), 0, Hp - 1)
    fx = torch.clamp(torch.div(torch.arange(W, device=dev) - stride // 2, stride, rounding_mode="floor"), 0, Wp - 1)
    dense_f = fmap[fy][:, fx]  # (H, W, 2)
    dense_w = wmap[fy][:, fx]
    num = filters.box_filter(dense_f * dense_w, radius)
    den = filters.box_filter(dense_w, radius)
    return num / torch.clamp(den, min=1e-9)


def variational_refine(I0, I1, flow, alpha: float = 8.0, outer: int = 3, iters: int = 30):
    """Brox-style variational refinement (cv::VariationalRefinement
    contract): linearise brightness constancy at the current flow, then
    solve the diffusion-regularised system with fixed Jacobi sweeps."""
    gy1, gx1 = filters.gradients(I1)
    maps = torch.stack([I1, gx1, gy1])
    for _ in range(outer):
        Iw, Ix, Iy = remap.remap(maps, flow[..., 0], flow[..., 1])
        It = Iw - I0
        c = It - Iy * flow[..., 0] - Ix * flow[..., 1]
        flow_d = flow
        for _ in range(iters):
            du = flow_d[..., 0] - flow[..., 0]
            dv = flow_d[..., 1] - flow[..., 1]
            r = It + Iy * du + Ix * dv
            psi = 1.0 / torch.sqrt(r * r + 1e-4)  # robust data weight (Charbonnier)
            nb = (torch.roll(flow_d, 1, 0) + torch.roll(flow_d, -1, 0)
                  + torch.roll(flow_d, 1, 1) + torch.roll(flow_d, -1, 1)) / 4.0  # 4-neighbour mean
            A11 = psi * Iy * Iy + alpha
            A22 = psi * Ix * Ix + alpha
            A12 = psi * Iy * Ix
            b1 = alpha * nb[..., 0] - psi * Iy * c
            b2 = alpha * nb[..., 1] - psi * Ix * c
            det = A11 * A22 - A12 * A12
            flow_d = torch.stack([(A22 * b1 - A12 * b2) / det, (A11 * b2 - A12 * b1) / det], dim=-1)
        flow = flow_d
    return flow


def compute(I0, I1, levels: int = 4, stride: int = 8, radius: int = 8, iters: int = 12,
            use_variational: bool = True):
    """DIS-class dense flow I0 -> I1 (float32 (H, W) tensors, on one
    device). Returns (H, W, 2) as (dy, dx)."""
    I0 = I0.to(torch.float32)
    I1 = I1.to(torch.float32)
    p0 = pyramid.build_pyramid(I0, levels)
    p1 = pyramid.build_pyramid(I1, levels)
    flow = torch.zeros(p0[-1].shape + (2,), dtype=torch.float32, device=I0.device)
    for l in reversed(range(levels)):
        if flow.shape[:2] != p0[l].shape:
            flow = resize(flow, p0[l].shape) * 2.0
        Hl, Wl = p0[l].shape
        # keep at least one patch center per axis on tiny coarse levels
        stride_l = max(2, min(stride, min(Hl, Wl) // 2))
        radius_l = min(radius, stride_l)
        flow = _level_patch_flow(p0[l], p1[l], flow, stride=stride_l, radius=radius_l, iters=iters)
        if use_variational:
            flow = variational_refine(p0[l], p1[l], flow)
    return flow


def epe(flow, flow_gt, mask=None):
    """End-point error (the Sintel benchmark metric)."""
    e = torch.linalg.norm(flow - flow_gt, dim=-1)
    if mask is not None:
        return torch.sum(e * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(e)
