"""BTV super-resolution: a conjugate-gradient solve of the multi-frame
reconstruction's normal equations with a smoothness prior (the port of
opencv_contrib_tpu/superres/btv.py).

Parity: superres BTV-L1 (superres/src/btv_l1.cpp,
createSuperResolution_BTVL1): optical-flow-aligned multi-frame fusion with a
bilateral-TV-class regularizer and pluggable dense flow (`flow.dis` plays
DenseOpticalFlowExt's role; on the card its pyramids launch pyrdown and its
variational refinement remap).

The data term sum_f |D W_f x - lr_f|^2 is linear least squares (W a
bilinear warp, D an area downsample), solved by CG on the normal equations.
The twin takes the adjoint from `jax.linear_transpose`; here it is written
out: the downsample's adjoint spreads each low-res value over its block,
the warp's scatters each sample's four corner cotangents onto their pixels.
The sample coordinates are fixed for the whole solve, so each frame's
targets are sorted once (`ops.segment.segment_plan`) and every adjoint adds
them in index order (`segment_sum_planned`): no atomics, the same bits on a
rerun. The CG steps read nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.flow import dis
from opencv_contrib_tpu_torch.ops.image import grid_coords, resize, sample_bilinear
from opencv_contrib_tpu_torch.ops.segment import SegmentPlan, segment_plan, segment_sum_planned
from opencv_contrib_tpu_torch.utils.device import as_float


class _Warp(NamedTuple):
    """One frame's bilinear warp at fixed coordinates: the sample
    coordinates, their corner weights and the plan of its adjoint."""
    sy: torch.Tensor
    sx: torch.Tensor
    wy: torch.Tensor
    wx: torch.Tensor
    plan: SegmentPlan


def _warp(sy, sx, Hh: int, Wh: int) -> _Warp:
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)

    def flat(yi, xi):  # `_gather2d`'s clipped indices
        return (torch.clamp(yi, 0, Hh - 1) * Wh + torch.clamp(xi, 0, Wh - 1)).reshape(-1)

    ids = torch.cat([flat(y0i, x0i), flat(y0i, x0i + 1), flat(y0i + 1, x0i), flat(y0i + 1, x0i + 1)])
    return _Warp(sy, sx, sy - y0, sx - x0, segment_plan(ids, Hh * Wh))


def _warp_t(w: _Warp, g: torch.Tensor) -> torch.Tensor:
    """The adjoint of sample_bilinear(., w.sy, w.sx) applied to the
    cotangent g of its samples: the four corners' shares, in the twin's
    product order, summed onto their pixels."""
    top, bot = g * (1 - w.wy), g * w.wy
    vals = torch.cat([(top * (1 - w.wx)).reshape(-1), (top * w.wx).reshape(-1), (bot * (1 - w.wx)).reshape(-1),
                      (bot * w.wx).reshape(-1)])
    return segment_sum_planned(w.plan, vals).reshape(g.shape)


def btv_l1(frames, scale: int = 2, n_iters: int = 30, tau: float = None, lam: float = 2e-3,
           ref_index: int | None = None, flows=None, mu: float = 1e-4, outer_iters: int = 1):
    """Fuse low-res frames (a list of (H, W)) into a (scale H, scale W)
    frame. n_iters: CG steps; lam: the smoothness weight; mu: a ridge that
    pins the box downsample's null space. `flows` optionally supplies each
    frame's flow to the reference (LR px; the setOpticalFlow contract),
    else `flow.dis` estimates them. `tau` is kept for the API and unused."""
    frames = [as_float(f) for f in frames]
    dev = frames[0].device
    frames = [f.to(dev) for f in frames]
    if ref_index is None:
        ref_index = len(frames) // 2
    H, W = frames[0].shape
    Hh, Wh = H * scale, W * scale

    # flows f->ref (LR px): frame-f pixel q matches ref location q + flow(q)
    if flows is None:
        flows = [torch.zeros((H, W, 2), device=dev) if i == ref_index
                 else dis.compute(f, frames[ref_index], levels=3, use_variational=True)
                 for i, f in enumerate(frames)]
    else:
        flows = [as_float(fl).to(dev) for fl in flows]

    y, x = grid_coords(Hh, Wh, device=dev)
    warps = []
    for fl in flows:
        fl_hr = resize(fl, (Hh, Wh)) * scale
        warps.append(_warp(y + fl_hr[..., 0], x + fl_hr[..., 1], Hh, Wh))

    def fwd_one(hr, w: _Warp):
        """The linear forward model of one frame: warp, then area-downsample."""
        return sample_bilinear(hr, w.sy, w.sx).reshape(H, scale, W, scale).mean(dim=(1, 3))

    def adj_one(lr, w: _Warp):
        """Its adjoint: the block mean's (each value over its block, divided
        by the block's size), then the warp's."""
        spread = (lr / (scale * scale))[:, None, :, None].expand(H, scale, W, scale).reshape(Hh, Wh)
        return _warp_t(w, spread)

    def smooth_grad(hr):
        """The gradient of the quadratic smoothness prior |grad x|^2: the
        negated 5-point laplacian."""
        lap = (torch.roll(hr, 1, 0) + torch.roll(hr, -1, 0) + torch.roll(hr, 1, 1) + torch.roll(hr, -1, 1)
               - 4.0 * hr)
        return -lap

    def A(hr):
        """The normal operator: sum_f W'D'DW + lam (-lap) + mu I."""
        out = lam * smooth_grad(hr) + mu * hr
        for w in warps:
            out = out + adj_one(fwd_one(hr, w), w)
        return out

    b = torch.zeros((Hh, Wh), device=dev)
    for f, w in zip(frames, warps):
        b = b + adj_one(f, w)

    xk = resize(frames[ref_index], (Hh, Wh))
    r = b - A(xk)
    p, rs = r, torch.sum(r * r)
    for _ in range(n_iters):
        Ap = A(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-12)
        xk = xk + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / torch.clamp(rs, min=1e-12)) * p
        rs = rs_new
    out = torch.clamp(xk, 0.0, 1.0)
    # joint flow refinement: each frame's flow re-estimated against the
    # sharper reconstruction projected to LR, then a new solve
    for _ in range(max(outer_iters - 1, 0)):
        ref_lr = out.reshape(H, scale, W, scale).mean(dim=(1, 3))
        new_flows = [torch.zeros((H, W, 2), device=dev) if i == ref_index
                     else dis.compute(f, ref_lr, levels=3, use_variational=True) for i, f in enumerate(frames)]
        out = btv_l1(frames, scale=scale, n_iters=n_iters, lam=lam, ref_index=ref_index, flows=new_flows, mu=mu,
                     outer_iters=1)
    return out
