"""RgbdNormals: the three normal-estimation methods of rgbd/src/normal.cpp
(the port of opencv_contrib_tpu/rgbd/normals.py).

- FALS: a per-pixel least-squares plane fit n . p = 1 over a window; the
  3x3 window scatter matrices are box-filtered product maps, and each
  pixel's system is solved by `torch.linalg.solve_ex` (no error check read
  back to the host; a singular system gives non-finite values, which the
  validity mask drops when the norm is not positive).
- LINEMOD: the cross product of the tangents from central differences of
  the back-projected points.
- SRI: the same after a masked Gaussian smoothing of the range image.

The functions run where their tensors are. The cross-product method of
KinFu lives in rgbd.frame.compute_normals.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.rgbd.frame import depth_to_points


def _orient_to_camera(n, points):
    flip = torch.sum(n * points, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def _unit(n):
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(norm, min=1e-12), norm[..., 0]


def _fals_system(depth: torch.Tensor, intr: torch.Tensor, radius: int = 3):
    """The FALS per-pixel system: (A (H, W, 3, 3) with the 1e-9 ridge, b
    (H, W, 3), points, valid)."""
    pts = depth_to_points(depth.to(torch.float32), intr)
    valid = depth > 0
    pw = pts * valid.to(torch.float32)[..., None]
    area = (2 * radius + 1) ** 2

    def box(x):
        return filters.box_filter(x, radius) * area

    S = {(i, j): box(pw[..., i] * pts[..., j]) for i in range(3) for j in range(i, 3)}
    b = torch.stack([box(pw[..., i]) for i in range(3)], dim=-1)
    A = torch.stack([
        torch.stack([S[(0, 0)], S[(0, 1)], S[(0, 2)]], dim=-1),
        torch.stack([S[(0, 1)], S[(1, 1)], S[(1, 2)]], dim=-1),
        torch.stack([S[(0, 2)], S[(1, 2)], S[(2, 2)]], dim=-1),
    ], dim=-2)
    return A + 1e-9 * torch.eye(3, device=A.device), b, pts, valid


def normals_fals(depth: torch.Tensor, intr: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """FALS normals: per pixel, the plane n . p = 1 fitted over the window's
    points ((sum p p^T) n = sum p)."""
    A, b, pts, valid = _fals_system(depth, intr, radius)
    n, norm = _unit(torch.linalg.solve_ex(A, b[..., None])[0][..., 0])
    n = _orient_to_camera(n, pts)
    return torch.where((valid & (norm > 1e-12))[..., None], n, 0.0)


def _tangent_normals(pts):
    tu = (torch.roll(pts, -1, 1) - torch.roll(pts, 1, 1)) / 2.0
    tv = (torch.roll(pts, -1, 0) - torch.roll(pts, 1, 0)) / 2.0
    n, norm = _unit(torch.linalg.cross(tv, tu, dim=-1))
    return _orient_to_camera(n, pts), norm


def normals_linemod(depth: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """LINEMOD normals: the cross product of the tangents along v and u of
    the back-projected surface (borders wrap, as in the JAX version)."""
    d = depth.to(torch.float32)
    valid = d > 0
    n, _ = _tangent_normals(depth_to_points(d, intr))
    ok = (valid & torch.roll(valid, -1, 1) & torch.roll(valid, 1, 1)
          & torch.roll(valid, -1, 0) & torch.roll(valid, 1, 0))
    return torch.where(ok[..., None], n, 0.0)


def normals_sri(depth: torch.Tensor, intr: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """SRI normals: smooth the range image (|p| rather than z) with a masked
    Gaussian, rebuild the points on the smoothed range along the original
    rays, then cross the tangents."""
    d = depth.to(torch.float32)
    valid = d > 0
    pts = depth_to_points(d, intr)
    rng = torch.linalg.norm(pts, dim=-1)
    rays = pts / torch.clamp(rng[..., None], min=1e-12)
    w = valid.to(torch.float32)
    rs = filters.gaussian_blur(rng * w, sigma) / torch.clamp(filters.gaussian_blur(w, sigma), min=1e-6)
    n, norm = _tangent_normals(rays * rs[..., None])
    return torch.where((valid & (norm > 1e-12))[..., None], n, 0.0)


METHODS = {"fals": normals_fals, "linemod": normals_linemod, "sri": normals_sri}


def rgbd_normals(depth: torch.Tensor, intr: torch.Tensor, method: str = "fals", **kw) -> torch.Tensor:
    """Factory dispatch (cv::rgbd::RgbdNormals::create(method))."""
    return METHODS[method](depth, intr, **kw)
