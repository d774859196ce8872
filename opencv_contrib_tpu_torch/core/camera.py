"""Pinhole camera with polynomial distortion — the port of the parts of
opencv_contrib_tpu/core/camera.py the keyframe tick uses. Intrinsics are a
flat (..., 9) vector [fx, fy, cx, cy, k1, k2, k3, p1, p2]."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.core import se3

FX, FY, CX, CY, K1, K2, K3, P1, P2 = range(9)
N_INTR = 9


def make_intrinsics(fx, fy=None, cx=0.0, cy=0.0, k1=0.0, k2=0.0, k3=0.0, p1=0.0, p2=0.0,
                    dtype=torch.float32, device="cpu") -> torch.Tensor:
    if fy is None:
        fy = fx
    return torch.tensor([fx, fy, cx, cy, k1, k2, k3, p1, p2], dtype=dtype, device=device)


def distort(intr: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Radial k1..k3 + tangential p1, p2 distortion of normalized (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    k1, k2, k3 = intr[..., K1], intr[..., K2], intr[..., K3]
    p1, p2 = intr[..., P1], intr[..., P2]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort(intr: torch.Tensor, xd: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert distortion by fixed-point iteration (fixed trip count)."""
    k1, k2, k3 = intr[..., K1], intr[..., K2], intr[..., K3]
    p1, p2 = intr[..., P1], intr[..., P2]
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return xn


def normalize_points(intr: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., 2) -> undistorted normalized camera coords."""
    c = torch.stack([intr[..., CX], intr[..., CY]], dim=-1)
    f = torch.stack([intr[..., FX], intr[..., FY]], dim=-1)
    return undistort(intr, (px - c) / f)


def denormalize_points(intr: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Normalized camera coords -> distorted pixel coords."""
    f = torch.stack([intr[..., FX], intr[..., FY]], dim=-1)
    c = torch.stack([intr[..., CX], intr[..., CY]], dim=-1)
    return distort(intr, xn) * f + c


def project(intr: torch.Tensor, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """World point (..., 3) -> (pixel (..., 2), depth)."""
    Xc = se3.rotate_points(R, X) + t
    z = Xc[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xn = Xc[..., :2] / zsafe[..., None]
    return denormalize_points(intr, xn), z


def look_at(eye: torch.Tensor, target: torch.Tensor, up=None):
    """World->cam (R, t) looking from `eye` to `target`, +z forward."""
    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], dtype=eye.dtype, device=eye.device)
    fwd = target - eye
    fwd = fwd / (torch.linalg.norm(fwd) + 1e-12)
    right = torch.linalg.cross(fwd, up)
    right = right / (torch.linalg.norm(right) + 1e-12)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=0)
    t = -R @ eye
    return R, t
