"""Visual-servoing twist estimation (tracking/include/opencv2/tracking/
twist.hpp), the port of opencv_contrib_tpu/tracking/twist.py: the 6-DoF
camera velocity from tracked image point velocities and depths through the
point-feature interaction matrix, duv = L @ xi with xi = (vx, vy, vz, wx,
wy, wz), solved by full-float32 normal equations (`solve_ex`: its status
stays on the device)."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

__all__ = ["interaction_matrix", "compute_twist"]


def interaction_matrix(uv: torch.Tensor, depths: torch.Tensor, K: torch.Tensor):
    """uv (N, 2) pixel coords, depths (N,), K (3, 3) intrinsics ->
    L (2N, 6) interaction matrix in NORMALIZED image coordinates."""
    uv = uv.to(torch.float32)
    Z = depths.to(torch.float32)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (uv[:, 0] - cx) / fx
    y = (uv[:, 1] - cy) / fy
    iZ = 1.0 / torch.clamp(Z, min=1e-9)
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    Lx = torch.stack([-iZ, zeros, x * iZ, x * y, -(ones + x * x), y], dim=1)
    Ly = torch.stack([zeros, -iZ, y * iZ, ones + y * y, -x * y, -x], dim=1)
    return torch.stack([Lx, Ly], dim=1).reshape(-1, 6)  # (2N, 6)


def compute_twist(uv: torch.Tensor, duv: torch.Tensor, depths: torch.Tensor, K: torch.Tensor):
    """computeTwist: pixel velocities duv (N, 2) -> camera twist (6,) =
    (v, omega); velocities are normalized by the focal length to match the
    interaction matrix's normalized coordinates."""
    L = interaction_matrix(uv, depths, K)
    fx, fy = K[0, 0], K[1, 1]
    dn = torch.stack([duv[:, 0] / fx, duv[:, 1] / fy], dim=1).reshape(-1)
    with f32_matmul_precision():
        A = L.T @ L + 1e-9 * torch.eye(6, device=L.device)
        return torch.linalg.solve_ex(A, L.T @ dn)[0]
