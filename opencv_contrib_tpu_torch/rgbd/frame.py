"""Depth frame pipeline: bilateral filter -> depth pyramid -> per-level
points + normals (the port of opencv_contrib_tpu/rgbd/frame.py;
makeFrameFromDepth, kinfu_frame.cpp:407).

Conventions: depth in meters, 0 = invalid; camera looks down +z; intr is the
core.camera 9-vector (distortion ignored for depth cameras).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.core import pyramid
from opencv_contrib_tpu_torch.ops import filters


class DepthFrame(NamedTuple):
    """One pyramid level: depth (H, W), points (H, W, 3), normals (H, W, 3),
    valid (H, W)."""

    depth: torch.Tensor
    points: torch.Tensor
    normals: torch.Tensor
    valid: torch.Tensor


def pixel_grid(H: int, W: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Row (v) and column (u) index maps (H, W) float32."""
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return v, u


def depth_to_points(depth: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Back-project a depth map to camera-frame points (H, W, 3)."""
    v, u = pixel_grid(*depth.shape, depth.device)
    x = (u - intr[2]) / intr[0] * depth
    y = (v - intr[3]) / intr[1] * depth
    return torch.stack([x, y, depth], dim=-1)


def compute_normals(points: torch.Tensor, valid: torch.Tensor):
    """Normals from central differences of the point map, oriented toward
    the camera; the differences and the validity mask WRAP at the borders
    (`torch.roll`, as the JAX version's `jnp.roll`). Returns (normals, ok)."""
    dx = torch.roll(points, -1, 1) - torch.roll(points, 1, 1)
    dy = torch.roll(points, -1, 0) - torch.roll(points, 1, 0)
    n = torch.linalg.cross(dy, dx, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * points, dim=-1, keepdim=True) > 0  # face the camera
    n = torch.where(flip, -n, n)
    ok = (valid
          & torch.roll(valid, -1, 1) & torch.roll(valid, 1, 1)
          & torch.roll(valid, -1, 0) & torch.roll(valid, 1, 0)
          & (norm[..., 0] > 1e-12))
    return torch.where(ok[..., None], n, 0.0), ok


def level_intrinsics(intr: torch.Tensor, levels_down: int = 1) -> torch.Tensor:
    """Halve focal length and center per pyramid level."""
    f = 0.5 ** levels_down
    return torch.cat([intr[:4] * f, intr[4:]])


def make_frame(depth: torch.Tensor, intr: torch.Tensor, levels: int = 3, sigma_depth: float = 0.04,
               sigma_spatial: float = 4.5, use_bilateral: bool = True) -> tuple[DepthFrame, ...]:
    """Full frame pipeline -> tuple of DepthFrame, finest first; the
    intrinsics halve per level."""
    d0 = filters.bilateral_filter(depth, sigma_spatial, sigma_depth, radius=3) if use_bilateral else depth
    depths = pyramid.build_depth_pyramid(d0, levels, sigma_depth)
    frames = []
    it = intr
    for d in depths:
        valid = d > 0
        pts = depth_to_points(d, it)
        normals, nvalid = compute_normals(pts, valid)
        frames.append(DepthFrame(depth=d, points=pts * valid[..., None], normals=normals, valid=nvalid))
        it = level_intrinsics(it, 1)
    return tuple(frames)
