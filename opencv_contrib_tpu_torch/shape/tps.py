"""Thin-plate-spline transformer (tps_trans.cpp parity; the port of
opencv_contrib_tpu/shape/tps.py): fit a TPS warp from control-point
correspondences, apply it to points. The solve is `linalg.solve_ex` (no
error check, so no host read) under full-f32 products."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


def _U(r2):
    return torch.where(r2 > 1e-12, r2 * 0.5 * torch.log(torch.clamp(r2, min=1e-12)), 0.0)


def tps_fit(src: torch.Tensor, dst: torch.Tensor, reg: float = 1e-6):
    """Fit TPS mapping src -> dst, both (N, 2). Returns params (w (N, 2),
    a (3, 2)) for f(x) = a0 + a1 x + a2 y + sum_i w_i U(|x - src_i|)."""
    N = src.shape[0]
    dev = src.device
    d2 = torch.sum((src[:, None] - src[None]) ** 2, dim=-1)
    K = _U(d2) + reg * torch.eye(N, device=dev)
    P = torch.cat([torch.ones((N, 1), device=dev), src], dim=1)  # (N, 3)
    A = torch.cat([torch.cat([K, P], 1), torch.cat([P.T, torch.zeros((3, 3), device=dev)], 1)], 0)
    rhs = torch.cat([dst, torch.zeros((3, 2), device=dev)], dim=0)
    with f32_matmul_precision():
        sol = torch.linalg.solve_ex(A + 1e-9 * torch.eye(N + 3, device=dev), rhs)[0]
    return sol[:N], sol[N:]


def tps_apply(params, src_ctrl: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply fitted TPS to points (M, 2)."""
    w, a = params
    d2 = torch.sum((pts[:, None] - src_ctrl[None]) ** 2, dim=-1)  # (M, N)
    with f32_matmul_precision():
        return a[0][None] + pts @ a[1:] + _U(d2) @ w
