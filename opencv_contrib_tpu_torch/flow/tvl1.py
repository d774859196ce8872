"""TV-L1 optical flow (Zach-Pock-Bischof primal-dual) — the port of
opencv_contrib_tpu/flow/tvl1.py (optflow's DualTVL1). Each outer iteration
warps I1 and its gradients at the flow with one remap launch (C = 3), then
runs the thresholding + primal-dual iterations elementwise and a 3x3 median
on the flow."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.core import pyramid
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.cuda import remap
from opencv_contrib_tpu_torch.ops.image import resize


def _grad(u):
    ux = torch.roll(u, -1, 1) - u
    uy = torch.roll(u, -1, 0) - u
    return uy, ux


def _div(py, px):
    return (py - torch.roll(py, 1, 0)) + (px - torch.roll(px, 1, 1))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _tvl1_level(I0, I1, flow, lam: float = 15.0, theta: float = 0.3, tau: float = 0.25, outer: int = 5,
                inner: int = 30):
    gy1, gx1 = filters.gradients(I1)
    maps = torch.stack([I1, gy1, gx1])
    # the JAX version traces lam, theta and tau as float32 scalars: their
    # products round in float32
    lt = _f32(np.float32(lam) * np.float32(theta))
    step = _f32(np.float32(tau) / np.float32(theta))
    u = flow
    p = torch.zeros(I0.shape + (2, 2), dtype=torch.float32, device=I0.device)  # dual
    for _ in range(outer):
        Iw, Iy, Ix = remap.remap(maps, u[..., 0], u[..., 1])
        rho_c = Iw - Iy * u[..., 0] - Ix * u[..., 1] - I0
        grad2 = Iy * Iy + Ix * Ix + 1e-9
        th = lt * grad2
        for _ in range(inner):
            # thresholding step (v update)
            rho = rho_c + Iy * u[..., 0] + Ix * u[..., 1]
            d = torch.where(rho < -th, lt, torch.where(rho > th, -lt, -rho / grad2))
            v = u + torch.stack([Iy * d, Ix * d], dim=-1)
            # dual ascent on p, primal descent on u (TV)
            u = torch.stack([v[..., 0] + theta * _div(p[..., 0, 0], p[..., 0, 1]),
                             v[..., 1] + theta * _div(p[..., 1, 0], p[..., 1, 1])], dim=-1)
            gyu, gxu = _grad(u[..., 0])
            gyv, gxv = _grad(u[..., 1])
            g = torch.stack([torch.stack([gyu, gxu], -1), torch.stack([gyv, gxv], -1)], dim=-2)
            p = p + step * g
            p = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1.0)
        u = torch.stack([filters.median_filter3(u[..., 0]), filters.median_filter3(u[..., 1])], dim=-1)
    return u


def compute(I0, I1, levels: int = 4, lam: float = 15.0, outer: int = 5, inner: int = 30):
    """TV-L1 dense flow I0 -> I1 (float32 (H, W) tensors, on one device) ->
    (H, W, 2) (dy, dx)."""
    I0 = I0.to(torch.float32)
    I1 = I1.to(torch.float32)
    p0 = pyramid.build_pyramid(I0, levels)
    p1 = pyramid.build_pyramid(I1, levels)
    flow = torch.zeros(p0[-1].shape + (2,), dtype=torch.float32, device=I0.device)
    for l in reversed(range(levels)):
        if flow.shape[:2] != p0[l].shape:
            flow = resize(flow, p0[l].shape) * 2.0
        flow = _tvl1_level(p0[l], p1[l], flow, lam=lam, outer=outer, inner=inner)
    return flow
