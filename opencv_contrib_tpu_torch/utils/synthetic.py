"""Synthetic scenes for tests and benchmarks — the port of
opencv_contrib_tpu/utils/synthetic.py::generate_scene. The random draws are
the same numpy draws as the JAX version's; the geometry runs in torch on the
CPU and the scene comes back as numpy arrays."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.core import camera as cam


class SyntheticScene(NamedTuple):
    points3d: np.ndarray  # (P, 3)
    Rs: np.ndarray  # (V, 3, 3) world->cam
    ts: np.ndarray  # (V, 3)
    K: np.ndarray  # (3, 3)
    intr: np.ndarray  # (9,)
    points2d: np.ndarray  # (V, P, 2) pixel observations
    visible: np.ndarray  # (V, P) bool


def generate_scene(
    n_views: int = 8,
    n_points: int = 200,
    seed: int = 0,
    image_size=(640, 480),
    radius: float = 4.0,
    noise_px: float = 0.0,
    distortion: bool = False,
) -> SyntheticScene:
    """Random cloud of points near the origin seen by cameras on a half
    ring looking in; observations exact plus optional Gaussian pixel noise."""
    rng = np.random.default_rng(seed)
    W, H = image_size
    f = 0.9 * W
    if distortion:
        intr = np.array([f, f, W / 2, H / 2, -0.1, 0.02, 0.0, 1e-3, -5e-4], np.float32)
    else:
        intr = np.array([f, f, W / 2, H / 2, 0, 0, 0, 0, 0], np.float32)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]], np.float32)

    pts = rng.uniform(-1.0, 1.0, size=(n_points, 3)).astype(np.float32)
    intr_t = torch.from_numpy(intr)
    pts_t = torch.from_numpy(pts)

    Rs, ts, obs, vis = [], [], [], []
    for i in range(n_views):
        angle = 2.0 * np.pi * i / max(n_views, 1) * 0.5  # half ring
        eye = np.array(
            [radius * np.sin(angle), 0.4 * rng.standard_normal(), -radius * np.cos(angle)],
            np.float32,
        )
        target = rng.uniform(-0.2, 0.2, size=3).astype(np.float32)
        R, t = cam.look_at(torch.from_numpy(eye), torch.from_numpy(target))
        px, z = cam.project(intr_t, R, t, pts_t)
        R, t, px, z = R.numpy(), t.numpy(), px.numpy(), z.numpy()
        v = (z > 0.1) & (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
        if noise_px > 0:
            px = px + rng.normal(scale=noise_px, size=px.shape).astype(np.float32)
        Rs.append(R)
        ts.append(t)
        obs.append(px)
        vis.append(v)

    return SyntheticScene(
        points3d=pts,
        Rs=np.stack(Rs),
        ts=np.stack(ts),
        K=K,
        intr=intr,
        points2d=np.stack(obs).astype(np.float32),
        visible=np.stack(vis),
    )
