"""PCAFlow: dense flow as a low-dimensional basis fitted to sparse matches —
the port of opencv_contrib_tpu/flow/pcaflow.py (optflow/src/pcaflow.cpp
OpticalFlowPCAFlow, with the DCT basis fallback for its learned prior).

LK tracks a sparse grid; the basis at the match sites and the ridge normal
equations are small matrix products; the dense field is one (HW, K) x (K, 2)
product."""

from __future__ import annotations

import math

import torch

from opencv_contrib_tpu_torch.flow import lk as lk_mod


def _cos_modes(u: torch.Tensor, k: int) -> torch.Tensor:
    """cos(pi u j) for j < k: (n,) -> (n, k)."""
    return torch.cos(math.pi * u[:, None] * torch.arange(k, device=u.device)[None])


def dct_basis(H: int, W: int, k: int = 6, device=None) -> torch.Tensor:
    """Separable DCT-II basis on the image grid: k*k smooth 2-D modes,
    (H, W, k*k)."""
    y = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H
    x = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W
    by, bx = _cos_modes(y, k), _cos_modes(x, k)
    B = by[:, None, :, None] * bx[None, :, None, :]
    return B.reshape(H, W, k * k)


def fit_flow(pts_yx, flows, valid, H: int, W: int, k: int = 6, ridge: float = 1e-2) -> torch.Tensor:
    """Fit the basis coefficients to sparse (point, flow) matches with ridge
    regularisation (the reference's learned prior acts as the regulariser).
    Returns the dense flow (H, W, 2)."""
    K = k * k
    by = _cos_modes((pts_yx[:, 0] + 0.5) / H, k)
    bx = _cos_modes((pts_yx[:, 1] + 0.5) / W, k)
    Phi = (by[:, :, None] * bx[:, None, :]).reshape(-1, K)  # (N, K)
    wm = valid.to(torch.float32)[:, None]
    A = (Phi * wm).T @ Phi + ridge * torch.eye(K, device=Phi.device)
    coef = torch.linalg.solve_ex(A, (Phi * wm).T @ (flows * wm))[0]  # (K, 2); no host check of the info
    B = dct_basis(H, W, k, device=Phi.device).reshape(-1, K)
    return (B @ coef).reshape(H, W, 2)


def compute(I0, I1, grid_stride: int = 8, k: int = 6, levels: int = 3) -> torch.Tensor:
    """PCAFlow dense flow I0 -> I1 ((H, W) tensors on one device): LK-track a
    sparse grid, fit the DCT basis, reconstruct densely. Returns (H, W, 2)
    (dy, dx)."""
    I0 = I0.to(torch.float32)
    I1 = I1.to(torch.float32)
    H, W = I0.shape
    ys = torch.arange(grid_stride // 2, H, grid_stride, dtype=torch.float32, device=I0.device)
    xs = torch.arange(grid_stride // 2, W, grid_stride, dtype=torch.float32, device=I0.device)
    pts = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    _, flow, valid = lk_mod.track(I0, I1, pts, levels=levels)
    return fit_flow(pts, flow, valid, H, W, k=k)
