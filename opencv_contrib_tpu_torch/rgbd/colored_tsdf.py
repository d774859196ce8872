"""Colored TSDF volume: RGB fused beside the signed distance (the port of
opencv_contrib_tpu/rgbd/colored_tsdf.py; colored_tsdf.cpp
ColoredTSDFVolumeCPU, colored_kinfu.cpp).

Integration gathers as `tsdf.integrate` does: every voxel projects into
the frame and pulls its depth and color; the color is fused with the same
weighted running average near the surface (|sdf| < trunc). The color
raycast reuses `tsdf.raycast`'s surface points and takes one trilinear
color sample at each hit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.rgbd import tsdf as tsdf_mod
from opencv_contrib_tpu_torch.rgbd.tsdf import _full, _project, _scalars


class ColoredTSDFVolume(NamedTuple):
    base: tsdf_mod.TSDFVolume
    color: torch.Tensor  # (X, Y, Z, 3) float32 in [0, 1]


def create(resolution=(128, 128, 128), size: float = 3.0, center=(0.0, 0.0, 0.0), trunc_dist: float | None = None,
           device="cpu") -> ColoredTSDFVolume:
    base = tsdf_mod.create(resolution, size, center, trunc_dist, device=device)
    return ColoredTSDFVolume(base, torch.zeros(base.dims + (3,), dtype=torch.float32, device=device))


def integrate(vol: ColoredTSDFVolume, depth: torch.Tensor, rgb: torch.Tensor, intr: torch.Tensor,
              T_cw: torch.Tensor, max_weight: float = 64.0, depth_max: float = 4.0) -> ColoredTSDFVolume:
    """Fuse one RGB-D frame (colored_tsdf.cpp integrate semantics): depth
    (H, W) in meters, rgb (H, W, 3) in [0, 1]."""
    b = vol.base
    X, Y, Z = b.dims
    H, W = depth.shape
    vs, trunc = _scalars(b)
    dev = depth.device
    grid = torch.stack(torch.meshgrid(*(torch.arange(n, dtype=torch.float32, device=dev) for n in (X, Y, Z)),
                                      indexing="ij"), dim=-1)
    pw = torch.addcmul(b.origin, grid, _full(vs, grid))
    del grid
    R, t = se3.mat_to_rt(T_cw)
    pc = torch.einsum("ij,xyzj->xyzi", R, pw) + t
    del pw
    z, vi, ui, inb = _project(pc, intr, H, W)
    del pc
    flat = torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)
    del vi, ui
    d = depth.reshape(-1)[flat]
    valid = inb & (d > 0) & (d < depth_max)
    sdf = d - z
    within = valid & (sdf > -trunc)
    tsdf_new = torch.clamp(sdf / _full(trunc, sdf), -1.0, 1.0)
    near = within & (torch.abs(sdf) < trunc)  # color only near the surface, as the reference
    c = rgb.reshape(-1, 3)[flat]  # (X, Y, Z, 3)
    del flat

    w_old = b.weight
    w_add = within.to(torch.float32)
    w_new = torch.clamp(w_old + w_add, max=max_weight)
    fused = torch.where(within, torch.addcmul(b.tsdf * w_old, tsdf_new, w_add) / torch.clamp(w_old + w_add, min=1.0),
                        b.tsdf)
    cw_add = near.to(torch.float32)[..., None]
    color = torch.where(near[..., None],
                        torch.addcmul(vol.color * w_old[..., None], c, cw_add)
                        / torch.clamp(w_old[..., None] + cw_add, min=1.0),
                        vol.color)
    return ColoredTSDFVolume(b._replace(tsdf=fused, weight=w_new), color)


def sample_color(vol: ColoredTSDFVolume, pts_world: torch.Tensor) -> torch.Tensor:
    """Trilinear color at world points (..., 3) (the raycast's color fetch)."""
    b = vol.base
    g = (pts_world - b.origin) / _full(_scalars(b)[0], pts_world)
    g0 = torch.floor(g)
    f = g - g0
    gi = g0.to(torch.int32)
    X, Y, Z = b.dims
    flat_color = vol.color.reshape(-1, 3)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = torch.clamp(gi[..., 0] + dx, 0, X - 1).long()
                iy = torch.clamp(gi[..., 1] + dy, 0, Y - 1).long()
                iz = torch.clamp(gi[..., 2] + dz, 0, Z - 1).long()
                w = ((f[..., 0] if dx else 1 - f[..., 0]) * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                out = out + flat_color[(ix * Y + iy) * Z + iz] * w[..., None]
    return out


def raycast_colored(vol: ColoredTSDFVolume, intr: torch.Tensor, T_cw: torch.Tensor, shape=(120, 160),
                    n_steps: int = 192):
    """Raycast depth and normals from the base volume, plus a color per
    pixel (the colored_kinfu render path). Returns (points_cam, normals_cam,
    colors, valid)."""
    pts_cam, normals, valid = tsdf_mod.raycast(vol.base, intr, T_cw, shape, n_steps)
    R_wc, t_wc = se3.mat_to_rt(se3.inverse(T_cw))
    pts_world = torch.einsum("ij,hwj->hwi", R_wc, pts_cam) + t_wc
    colors = sample_color(vol, pts_world)
    return pts_cam, normals, torch.where(valid[..., None], colors, 0.0), valid
