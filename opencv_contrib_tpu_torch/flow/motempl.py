"""Motion templates (motion history images) — the port of
opencv_contrib_tpu/flow/motempl.py (optflow/src/motempl.cpp:
updateMotionHistory, calcMotionGradient, calcGlobalOrientation)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops import filters


def update_motion_history(mhi: torch.Tensor, silhouette: torch.Tensor, timestamp: float,
                          duration: float) -> torch.Tensor:
    """cv::motempl::updateMotionHistory: set mhi = timestamp where moving,
    clear entries older than timestamp - duration."""
    mhi = torch.where(silhouette > 0, timestamp, mhi)
    return torch.where(mhi < timestamp - duration, 0.0, mhi)


def _window(x: torch.Tensor, aperture: int, fill: float, op) -> torch.Tensor:
    """lax.reduce_window over aperture x aperture, stride 1, "SAME" padding
    with `fill` (max_pool2d of x, or of -x for a min)."""
    lo, hi = (aperture - 1) // 2, aperture // 2
    p = F.pad(x[None, None], (lo, hi, lo, hi), value=fill)
    return op(p, aperture)[0, 0]


def calc_motion_gradient(mhi: torch.Tensor, delta1: float, delta2: float, aperture: int = 3):
    """Orientation (degrees in [0, 360)) of the MHI gradient + validity mask
    (cv::motempl::calcMotionGradient)."""
    gy = filters.sobel(mhi, dx=0, dy=1)
    gx = filters.sobel(mhi, dx=1, dy=0)
    orient = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)), 360.0)
    lo, hi = min(delta1, delta2), max(delta1, delta2)
    # valid where the local mhi range lies within [lo, hi]
    mx = _window(mhi, aperture, -math.inf, lambda p, a: F.max_pool2d(p, a, stride=1))
    mn = _window(torch.where(mhi > 0, mhi, math.inf), aperture, math.inf,
                 lambda p, a: -F.max_pool2d(-p, a, stride=1))
    rng = torch.where(torch.isfinite(mn), mx - mn, 0.0)
    valid = (rng >= lo) & (rng <= hi) & (mhi > 0)
    return orient, valid


def calc_global_orientation(orient: torch.Tensor, mask: torch.Tensor, mhi: torch.Tensor, timestamp: float,
                            duration: float) -> torch.Tensor:
    """Dominant motion direction (degrees, a 0-d tensor) weighted by recency
    (cv::motempl::calcGlobalOrientation)."""
    w = torch.where(mask, torch.clamp((mhi - (timestamp - duration)) / max(duration, 1e-9), 0, 1), 0.0)
    rad = torch.deg2rad(orient)
    s = torch.sum(w * torch.sin(rad))
    c = torch.sum(w * torch.cos(rad))
    return torch.remainder(torch.rad2deg(torch.atan2(s, c)), 360.0)
