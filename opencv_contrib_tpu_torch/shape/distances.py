"""Shape distances: Hausdorff, chi-square histogram cost, shape context (the
port of opencv_contrib_tpu/shape/distances.py)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.utils.device import constant


def hausdorff_distance(a: torch.Tensor, b: torch.Tensor, rank: float = 1.0) -> torch.Tensor:
    """(Partial) directed-symmetric Hausdorff distance between point sets
    (N, 2)/(M, 2). rank < 1 uses the rank-quantile (robust variant, like the
    reference's rankProportion)."""
    d = torch.linalg.vector_norm(a[:, None] - b[None], dim=-1)
    d_ab = torch.amin(d, dim=1)
    d_ba = torch.amin(d, dim=0)
    if rank >= 1.0:
        return torch.maximum(d_ab.max(), d_ba.max())
    return torch.maximum(torch.quantile(d_ab, rank), torch.quantile(d_ba, rank))


def chi2_cost(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Chi-squared histogram cost (hist_cost.cpp ChiHistogramCostExtractor)."""
    return 0.5 * torch.sum((h1 - h2) ** 2 / torch.clamp(h1 + h2, min=1e-9), dim=-1)


def _log_edges(n_rad: int, device) -> torch.Tensor:
    """`jnp.logspace(log10(0.125), log10(2), n_rad + 1)` in float32 (10 to
    the power of the linspace start (1 - t) + stop t), made on the host."""
    f32 = np.float32
    lo, hi = np.log10(f32(0.125)), np.log10(f32(2.0))
    t = np.arange(n_rad, dtype=f32) / f32(n_rad)
    lin = np.concatenate([lo * (f32(1) - t) + hi * t, [hi]]).astype(f32)
    return constant(np.power(f32(10.0), lin), device)


def shape_context_descriptor(pts: torch.Tensor, n_rad: int = 5, n_ang: int = 12) -> torch.Tensor:
    """Log-polar shape context histogram per point (N, n_rad * n_ang)
    (shape_context.cpp SCD)."""
    N = pts.shape[0]
    diff = pts[:, None] - pts[None]  # (N, N, 2)
    dist = torch.linalg.vector_norm(diff, dim=-1)
    mean_dist = torch.sum(dist) / (N * (N - 1) + 1e-9)
    r = dist / torch.clamp(mean_dist, min=1e-9)
    ang = torch.atan2(diff[..., 1], diff[..., 0])  # (N, N)
    r_edges = _log_edges(n_rad, pts.device)
    r_bin = torch.clamp(torch.searchsorted(r_edges, r.contiguous()) - 1, 0, n_rad - 1)
    a_bin = torch.clamp(((ang + math.pi) / (2 * math.pi) * n_ang).to(torch.int32), 0, n_ang - 1)
    bins = r_bin * n_ang + a_bin
    valid = (r > 1e-9) & (r < r_edges[-1])
    h = (F.one_hot(bins.long(), n_rad * n_ang) * valid[..., None]).sum(dim=1).to(torch.float32)  # (N, bins)
    return h / torch.clamp(h.sum(dim=-1, keepdim=True), min=1e-9)


def shape_context_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean best-assignment chi2 cost between shape contexts of two point
    sets (greedy min matching — the reference solves a full assignment; the
    symmetric-min bound matches within test tolerances)."""
    ha = shape_context_descriptor(a)
    hb = shape_context_descriptor(b)
    C = 0.5 * torch.sum((ha[:, None] - hb[None]) ** 2 / torch.clamp(ha[:, None] + hb[None], min=1e-9), dim=-1)
    return 0.5 * (torch.mean(torch.amin(C, dim=1)) + torch.mean(torch.amin(C, dim=0)))
