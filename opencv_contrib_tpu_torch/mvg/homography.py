"""Homography estimation (4-point DLT) and its transfer error — the port of
opencv_contrib_tpu/mvg/homography.py, with leading batch dimensions."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.mvg import conditioning
from opencv_contrib_tpu_torch.mvg.fundamental import _normalize_by_22, _smallest_singular_vector


def dlt(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized DLT homography from (..., N >= 4, 2) correspondences
    x2 ~ H x1, with a validity mask (..., N). Returns H (..., 3, 3)."""
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=torch.bool, device=x1.device)
    T1 = conditioning.preconditioner_from_points(x1, mask)
    T2 = conditioning.preconditioner_from_points(x2, mask)
    a = conditioning.apply_transform(T1, x1)
    b = conditioning.apply_transform(T2, x2)
    u1, v1 = a[..., 0], a[..., 1]
    u2, v2 = b[..., 0], b[..., 1]
    zero = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    r1 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([zero, zero, zero, u1, v1, one, -v2 * u1, -v2 * v1, -v2], dim=-1)
    m = torch.cat([mask, mask], dim=-1).to(x1.dtype)
    A = torch.cat([r1, r2], dim=-2) * m[..., None]
    H = _smallest_singular_vector(A).reshape(A.shape[:-2] + (3, 3))
    return _normalize_by_22(torch.linalg.inv_ex(T2)[0] @ H @ T1)


def transfer_error(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared forward transfer error |H x1 - x2|^2: H (..., 3, 3), points
    (..., N, 2) -> (..., N)."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    y = torch.einsum("...ij,...nj->...ni", H, x1h)
    w = y[..., 2:]
    y = y[..., :2] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return torch.sum((y - x2) ** 2, dim=-1)
