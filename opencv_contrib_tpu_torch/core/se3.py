"""SO(3) operations on stacked tensors — the port of the parts of
opencv_contrib_tpu/core/se3.py the keyframe tick uses. Singularities are
handled with `torch.where` and safe denominators, as in the JAX version."""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_coeffs(theta2: torch.Tensor):
    """Rodrigues coefficients A = sin(t)/t, B = (1-cos(t))/t^2 of theta2 = t^2,
    with the small-angle Taylor branch; also dA/dtheta2 and dB/dtheta2 of the
    same branches (what forward-mode autodiff of exp_so3 differentiates)."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    one = torch.ones_like(theta2)
    theta2_safe = torch.where(small, one, theta2)
    sin, cos = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos) / theta2_safe)
    dtheta = 0.5 / theta
    dA = torch.where(small, -one / 6.0, (cos / theta - sin / (theta * theta)) * dtheta)
    dB = torch.where(small, -one / 24.0,
                     sin * dtheta / theta2_safe - (1.0 - cos) / (theta2_safe * theta2_safe))
    return A, B, dA, dB


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: angle-axis (..., 3) -> rotation (..., 3, 3), with a
    Taylor branch at theta -> 0."""
    A, B, _, _ = so3_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    I = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Matrix log: rotation (..., 3, 3) -> angle-axis (..., 3), through the
    quaternion (stable near 0 and pi)."""
    return quat_to_axis_angle(mat_to_quat(R))


def rotate_points(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    if pts.ndim == R.ndim - 1:
        return torch.einsum("...ij,...j->...i", R, pts)
    return torch.einsum("...ij,...nj->...ni", R, pts)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> quaternion (w, x, y, z), branch-free (Shepperd): all four
    candidates are built and the best-conditioned one is selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cand = torch.stack([cw, cx, cy, cz], dim=-2)  # (..., 4cand, 4comp)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = quat_normalize(torch.gather(cand, -2, idx)[..., 0, :])
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    s = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(s, w)
    scale = torch.where(s < _EPS, torch.full_like(s, 2.0), theta / torch.clamp(s, min=_EPS))
    return xyz * scale[..., None]


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation via SVD (handles reflections)."""
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vh)
    one = torch.ones_like(det)[..., None]
    D = torch.cat([one, one, det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vh
