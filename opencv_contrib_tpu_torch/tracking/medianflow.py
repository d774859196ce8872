"""MedianFlow tracker: forward-backward LK point tracking with median
displacement and scale voting (the port of
opencv_contrib_tpu/tracking/medianflow.py).

Reference anchor: tracking/src/trackerMedianFlow.cpp (the trackPoints grid,
the forward-backward error, NCC filtering, the median dx / dy and the median
pairwise-distance-ratio scale update).

The point grid is static (G x G); forward and backward LK are one batched
pyramidal solve each (`flow.lk.track`: at `levels` 3 its two pyramids a
call are 2 pyrdown launches each, 8 a step); the gates are masked medians
by sort, on the device with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.flow import lk
from opencv_contrib_tpu_torch.ops.image import extract_patches


class Box(NamedTuple):
    center: torch.Tensor  # (2,) y, x
    size: torch.Tensor  # (2,) h, w


def _masked_median(x, mask):
    """The median of x where mask, by sorting with +inf fill: the middle
    element of an odd count, the mean of the two middles of an even one
    (`torch.median` would return the lower); 0 where nothing is masked."""
    big = torch.where(mask, x, torch.full_like(x, float("inf")))
    s = torch.sort(big).values
    n = mask.sum()
    i = torch.clamp(n - 1, min=0) // 2
    lo = torch.take(s, i)
    hi = torch.take(s, torch.where(n > 0, torch.clamp(i + (1 - n % 2), max=x.shape[0] - 1), torch.zeros_like(n)))
    return torch.where(n > 0, 0.5 * (lo + hi), torch.zeros_like(lo))


def _ncc(a, b):
    a = a - a.mean(dim=-1, keepdim=True)
    b = b - b.mean(dim=-1, keepdim=True)
    num = (a * b).sum(-1)
    den = torch.sqrt((a * a).sum(-1) * (b * b).sum(-1)) + 1e-9
    return num / den


def medianflow_update(box: Box, I0, I1, grid: int = 10, levels: int = 3):
    """Track box from I0 to I1. Returns (new_box, ok); ok False means
    tracking failure (the reference's forward-backward error gate,
    trackerMedianFlow.cpp MEDIAN_FLOW_FB_ERROR), a 0-dim bool tensor."""
    dev = I1.device
    gy = (torch.arange(grid, device=dev) + 0.5) / grid - 0.5
    py = box.center[0] + gy * box.size[0]
    px = box.center[1] + gy * box.size[1]
    pts = torch.stack(torch.meshgrid(py, px, indexing="ij"), dim=-1).reshape(-1, 2)

    fwd, _, v1 = lk.track(I0, I1, pts, levels=levels)
    back, _, v2 = lk.track(I1, I0, fwd, levels=levels)
    fb_err = torch.linalg.norm(back - pts, dim=1)

    p0 = extract_patches(I0, pts, 5).reshape(pts.shape[0], -1)
    p1 = extract_patches(I1, fwd, 5).reshape(pts.shape[0], -1)
    ncc = _ncc(p0, p1)

    valid = v1 & v2
    med_fb = _masked_median(fb_err, valid)
    med_ncc = _masked_median(-ncc, valid)  # median of negated => keep ncc >= median
    keep = valid & (fb_err <= med_fb) & (-ncc <= med_ncc)

    d = fwd - pts
    dy = _masked_median(d[:, 0], keep)
    dx = _masked_median(d[:, 1], keep)

    # scale: the median of pairwise distance ratios over kept points
    n = pts.shape[0]
    ii, jj = torch.triu_indices(n, n, offset=1, device=dev)
    d0 = torch.linalg.norm(pts[ii] - pts[jj], dim=1)
    d1 = torch.linalg.norm(fwd[ii] - fwd[jj], dim=1)
    pair_ok = keep[ii] & keep[jj] & (d0 > 1e-3)
    ratio = torch.where(pair_ok, d1 / torch.clamp(d0, min=1e-3), torch.ones_like(d0))
    scale = _masked_median(ratio, pair_ok)
    scale = torch.where(pair_ok.sum() > 0, scale, torch.ones_like(scale))

    ok = (keep.sum() >= max(4, grid * grid // 10)) & (
        med_fb < 2.0 * torch.sqrt(torch.sum(torch.square(d.mean(0)))) + 10.0)
    return Box(box.center + torch.stack([dy, dx]), box.size * scale), ok
