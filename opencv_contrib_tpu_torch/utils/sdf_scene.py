"""Synthetic SDF-raymarched depth scenes, the KinFu fixture (the port's own
copy of opencv_contrib_tpu/utils/sdf_scene.py; test_kinfu.cpp:36-171 renders
depth frames by sphere-tracing an implicit surface along a known orbit)."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.core import camera as cam
from opencv_contrib_tpu_torch.core import se3


def sdf_cube_spheres(p: torch.Tensor) -> torch.Tensor:
    """Cube + two spheres around the origin, and a backdrop half-space
    (solid y >= 1) so most rays hit a surface. p (..., 3) -> distance (...)."""
    q = torch.abs(p) - 0.5
    box = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(q.amax(dim=-1), max=0.0)
    c1 = torch.tensor([0.0, 0.7, 0.0], device=p.device)
    c2 = torch.tensor([0.6, -0.3, 0.4], device=p.device)
    s1 = torch.linalg.norm(p - c1, dim=-1) - 0.3
    s2 = torch.linalg.norm(p - c2, dim=-1) - 0.2
    floor = 1.0 - p[..., 1]
    return torch.minimum(torch.minimum(box, floor), torch.minimum(s1, s2))


def render_depth(T_wc: torch.Tensor, intr: torch.Tensor, sdf=sdf_cube_spheres, shape=(120, 160),
                 n_steps: int = 64, max_depth: float = 6.0) -> torch.Tensor:
    """Sphere-trace a depth map from camera pose T_wc (cam->world 4x4), on
    the device of T_wc. Returns depth (H, W) in meters, 0 where no hit."""
    H, W = shape
    dev = T_wc.device
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    dirs_cam = torch.stack([(u - intr[2]) / intr[0], (v - intr[3]) / intr[1], torch.ones_like(u)], dim=-1)
    R, t = se3.mat_to_rt(T_wc)
    dirs = torch.einsum("ij,hwj->hwi", R, dirs_cam)
    dir_norm = torch.clamp(torch.linalg.norm(dirs, dim=-1), min=1e-9)
    z = torch.full((H, W), 0.2, dtype=torch.float32, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for _ in range(n_steps):  # z is the z-depth: a world step of d is d/|dir| in z
        d = sdf(t + dirs * z[..., None])
        done = done | (d < 1e-3)
        z = torch.where(done, z, z + torch.clamp(d / dir_norm, min=1e-4))
    return torch.where(done & (z < max_depth), z, 0.0)


def orbit_poses(n_frames: int, radius: float = 2.2, height: float = 0.3, sweep=0.8) -> np.ndarray:
    """Camera orbit looking at the origin: (n, 4, 4) cam->world poses."""
    poses = []
    for i in range(n_frames):
        a = sweep * (i / max(n_frames - 1, 1) - 0.5)
        eye = torch.tensor([radius * np.sin(a), height * np.cos(3 * a), -radius * np.cos(a)], dtype=torch.float32)
        R, t = cam.look_at(eye, torch.zeros(3))
        poses.append(se3.inverse(se3.rt_to_mat(R, t)).numpy())
    return np.stack(poses)
