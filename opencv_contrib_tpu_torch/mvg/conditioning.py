"""Point conditioning (isotropic normalization) for DLT-type solvers — the
port of opencv_contrib_tpu/mvg/conditioning.py. Point sets carry leading
batch dimensions and an optional validity mask (padded static shapes)."""

from __future__ import annotations

import math

import torch


def preconditioner_from_points(pts: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Isotropic scaling transform T (..., 3, 3) so that T x has zero mean and
    mean distance sqrt(2) from the origin. pts (..., N, 2), mask (..., N)."""
    if mask is None:
        mask = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=-2) / n[..., None]  # (..., 2)
    d = torch.sqrt(torch.sum((pts - mean[..., None, :]) ** 2, dim=-1)) * w
    meandist = torch.sum(d, dim=-1) / n
    scale = math.sqrt(2.0) / torch.clamp(meandist, min=1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    return torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], dim=-1),
        torch.stack([zero, scale, -scale * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def apply_transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply homogeneous (..., 3, 3) transforms to (..., N, 2) points."""
    T = T[..., None, :, :]
    x = pts[..., 0] * T[..., 0, 0] + pts[..., 1] * T[..., 0, 1] + T[..., 0, 2]
    y = pts[..., 0] * T[..., 1, 0] + pts[..., 1] * T[..., 1, 1] + T[..., 1, 2]
    w = pts[..., 0] * T[..., 2, 0] + pts[..., 1] * T[..., 2, 1] + T[..., 2, 2]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return torch.stack([x / w, y / w], dim=-1)
