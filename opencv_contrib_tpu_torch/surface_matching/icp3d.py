"""Point-cloud ICP (the port of opencv_contrib_tpu/surface_matching/icp3d.py;
parity: surface_matching's standalone ICP, icp.hpp:80 registerModelToScene:
point-to-plane minimization with nearest-neighbor correspondence, iteration
pyramid via subsampling; this is the reference's unordered-cloud ICP,
distinct from the projective KinFu one).

The nearest neighbour is a brute-force distance matrix (a full-fp32 matrix
product) and its first minimum; each level's iterations step in Python,
the 6x6 solve by `torch.linalg.solve_ex` and a non-finite step replaced by
zero on the device, so the loop makes no host read; the residual is read
once, at the end."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.utils.device import as_float, to_device
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


def _nearest(model_pts, scene_pts):
    d = (torch.sum(model_pts * model_pts, dim=1)[:, None] + torch.sum(scene_pts * scene_pts, dim=1)[None]
         - 2.0 * model_pts @ scene_pts.T)
    dmin, idx = torch.min(d, dim=1)
    return idx, dmin


def _icp_level(T0, model_pts, scene_pts, scene_nrm, iters: int, dist_gate: float):
    eye6 = torch.eye(6, device=T0.device)
    T, err = T0, None
    with f32_matmul_precision():
        for _ in range(iters):
            R, t = se3.mat_to_rt(T)
            mp = model_pts @ R.T + t
            idx, d2 = _nearest(mp, scene_pts)
            q = scene_pts[idx]
            n = scene_nrm[idx]
            w = (d2 < dist_gate * dist_gate).to(torch.float32)
            r = torch.sum(n * (mp - q), dim=1)
            Jw = torch.linalg.cross(mp, n)
            J = torch.cat([Jw, n], dim=1) * w[:, None]
            A = J.T @ J
            b = -J.T @ (r * w)
            dx = torch.linalg.solve_ex(A + 1e-6 * eye6, b)[0]
            dx = torch.where(torch.all(torch.isfinite(dx)), dx, torch.zeros_like(dx))
            T = se3.exp_se3(dx) @ T
            err = torch.sum(w * r * r) / torch.clamp(torch.sum(w), min=1.0)
    return T, err


def register_model_to_scene(
    model_pts,
    scene_pts,
    scene_normals,
    T_init=None,
    levels: int = 3,
    iters_per_level: int = 10,
    dist_gate: float = 0.5,
):
    """Refine T (model->scene) with coarse-to-fine subsampled point-to-plane
    ICP (registerModelToScene contract). Returns (T (4, 4) on the model's
    device, residual as a float)."""
    model_pts = as_float(model_pts)
    dev = model_pts.device
    scene_pts = to_device(scene_pts, dev)
    scene_normals = to_device(scene_normals, dev)
    T = torch.eye(4, device=dev) if T_init is None else to_device(T_init, dev)
    err = None
    for lv in reversed(range(levels)):
        step = 2 ** lv
        T, err = _icp_level(T, model_pts[::step], scene_pts[::step], scene_normals[::step],
                            iters=iters_per_level, dist_gate=dist_gate * (lv + 1))
    return T, float(err) if err is not None else float("inf")
