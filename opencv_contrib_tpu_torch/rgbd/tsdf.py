"""Dense TSDF volume: integration, raycast, point extraction (the port of
opencv_contrib_tpu/rgbd/tsdf.py; tsdf.cpp TSDFVolumeCPU::integrate,
RaycastInvoker, fetchPointsNormals).

Volume semantics are the JAX package's: truncated signed distance in
[-1, 1] (scaled by trunc_dist), weighted running average, weight capped.
Integration gathers: every voxel projects into the depth image and pulls
its sample.

The JAX version works around the TPU's slow gathers with one-hot matmul
lookups, corner-stacked tables and 128-wide row scatters of deltas. Here
voxels and depth pixels are indexed directly, which gives the same values
(a selected block's voxels are written once, since the selected blocks are
distinct). Products of the form a * b + c are written as `addcmul`, which
on the CPU is one fused multiply-add, as XLA's CPU compiler emits it: that
keeps voxel-to-pixel rounding the same as the JAX package's on the CPU.

`create` keeps `voxel_size` and `trunc_dist` as float32 scalars on the
host, so that reading them never waits for the device. Scalars derived
from them are rounded to float32 after each operation, as the JAX package
computes them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.rgbd.frame import pixel_grid


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor  # (X, Y, Z) float32 in [-1, 1]
    weight: torch.Tensor  # (X, Y, Z) float32
    origin: torch.Tensor  # (3,) world coords of voxel (0,0,0) center
    voxel_size: torch.Tensor  # scalar
    trunc_dist: torch.Tensor  # scalar (meters)

    @property
    def dims(self):
        return tuple(self.tsdf.shape)


def create(resolution=(128, 128, 128), size: float = 3.0, center=(0.0, 0.0, 0.0), trunc_dist: float | None = None,
           device="cpu") -> TSDFVolume:
    """Volume of `size` meters per side centered at `center`, on `device`."""
    vs = size / resolution[0]
    if trunc_dist is None:
        trunc_dist = 5.0 * vs
    origin = torch.tensor(center, dtype=torch.float32) - size / 2.0 + vs / 2.0
    return TSDFVolume(
        tsdf=torch.zeros(resolution, dtype=torch.float32, device=device),
        weight=torch.zeros(resolution, dtype=torch.float32, device=device),
        origin=origin.to(device),
        voxel_size=torch.tensor(vs, dtype=torch.float32),
        trunc_dist=torch.tensor(trunc_dist, dtype=torch.float32),
    )


_f32 = np.float32


def _scalars(vol: TSDFVolume) -> tuple[float, float]:
    """(voxel_size, trunc_dist) as Python floats."""
    return float(vol.voxel_size), float(vol.trunc_dist)


def _full(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on `like`'s device (a fill, not a copy from
    the host), for the tensor arguments of `addcmul`."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _project(pc: torch.Tensor, intr: torch.Tensor, H: int, W: int):
    """Camera-frame points (..., 3) -> (z, vi, ui, in-image mask); pixel
    indices rounded half to even."""
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-9)
    u = torch.addcmul(intr[2], pc[..., 0] / zs, intr[0])
    v = torch.addcmul(intr[3], pc[..., 1] / zs, intr[1])
    ui = torch.round(u).long()
    vi = torch.round(v).long()
    inb = (z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    return z, vi, ui, inb


def _fuse(t_old, w_old, vox, vol: TSDFVolume, depth, intr, T_cw, max_weight, depth_max, gate=None):
    """The per-voxel update of integrateVolumeUnit for voxel indices
    `vox` (..., 3) int64 with current values t_old, w_old: returns the new
    (tsdf, weight). Voxels where `gate` is False keep their values."""
    H, W = depth.shape
    vs, trunc = _scalars(vol)
    R, t = se3.mat_to_rt(T_cw)
    pw = torch.addcmul(vol.origin, vox.to(torch.float32), _full(vs, vox))  # world
    pc = torch.einsum("ij,...j->...i", R, pw) + t
    z, vi, ui, inb = _project(pc, intr, H, W)
    d = depth.reshape(-1)[torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)]
    valid = inb & (d > 0) & (d < depth_max)
    sdf = d - z
    within = valid & (sdf > -trunc)
    if gate is not None:
        within = within & gate
    tsdf_new = torch.clamp(sdf / trunc, -1.0, 1.0)
    w_add = within.to(torch.float32)
    w_new = torch.clamp(w_old + w_add, max=max_weight)
    fused = torch.where(within, torch.addcmul(t_old * w_old, tsdf_new, w_add) / torch.clamp(w_old + w_add, min=1.0),
                        t_old)
    return fused, w_new


def _voxel_grid(X: int, Y: int, Z: int, device) -> torch.Tensor:
    axes = [torch.arange(n, device=device) for n in (X, Y, Z)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def integrate(vol: TSDFVolume, depth, intr, T_cw, max_weight: float = 64.0, depth_max: float = 4.0,
              gate=None) -> TSDFVolume:
    """Fuse one depth frame taken at world->camera pose T_cw into every
    voxel (integrateVolumeUnit semantics). `gate` (a bool tensor, or None)
    masks the whole update, as in `integrate_sparse`."""
    tsdf, weight = _fuse(vol.tsdf, vol.weight, _voxel_grid(*vol.dims, vol.tsdf.device), vol, depth, intr, T_cw,
                         max_weight, depth_max, gate)
    return vol._replace(tsdf=tsdf, weight=weight)


def _active_blocks(vol: TSDFVolume, depth, intr, T_cw, depth_max: float, bs: int, carve: bool):
    """Blocks whose truncation band a depth ray passes through (the
    hash_tsdf allocation strategy, hash_tsdf.cpp:190): subsampled rays mark
    an octant grid (half-block cells) at points along their band, a 3^3
    max-dilation makes the set conservative, and octants reduce to blocks.
    Returns the (Bx * By * Bz,) bool mask."""
    X, Y, Z = vol.dims
    Bx, By, Bz = X // bs, Y // bs, Z // bs
    H, W = depth.shape
    R, t = se3.mat_to_rt(T_cw)
    vs, trunc = _scalars(vol)
    R_wc = R.T
    t_wc = -R.T @ t
    sub = 2 if (H % 2 == 0 and W % 2 == 0 and H >= 240) else 1
    dss = depth[::sub, ::sub]
    vv, uu = pixel_grid(*dss.shape, depth.device)
    dir_cam = torch.stack([(uu * sub - intr[2]) / intr[0], (vv * sub - intr[3]) / intr[1], torch.ones_like(uu)],
                          dim=-1)
    ray_ok = (dss > 0) & (dss < depth_max)
    Ox, Oy, Oz = 2 * Bx, 2 * By, 2 * Bz
    no = Ox * Oy * Oz
    grid = torch.zeros(no + 1, dtype=torch.float32, device=depth.device)  # last slot: dropped marks
    if carve:
        n_marks = int(math.ceil(depth_max / (bs * vs / 2))) + 2
    else:
        n_marks = max(3, int(math.ceil(2.0 * trunc / (bs * vs))) + 1)
    for k in range(n_marks):
        if carve:
            zk = torch.where(ray_ok, (k + 0.5) / n_marks * (dss + trunc), -1.0)
        else:
            zk = torch.where(ray_ok, dss + float(_f32(trunc) * _f32(2.0 * k / (n_marks - 1) - 1.0)), -1.0)
        pw = torch.einsum("ij,hwj->hwi", R_wc, dir_cam * zk[..., None]) + t_wc
        g = (pw - vol.origin) / float(_f32(vs) * bs / 2)  # octant cells
        gi = torch.floor(g).long()
        # marks up to one octant outside clamp to the boundary cell; farther ones are dropped
        near = ((zk > 0) & torch.all(gi >= -1, dim=-1)
                & (gi[..., 0] <= Ox) & (gi[..., 1] <= Oy) & (gi[..., 2] <= Oz))
        gx, gy, gz = (gi[..., a].clamp(0, n - 1) for a, n in enumerate((Ox, Oy, Oz)))
        flat = (gx * Oy + gy) * Oz + gz
        grid.index_fill_(0, torch.where(near, flat, no).reshape(-1), 1.0)  # no host copy of the value
    goct = F.max_pool3d(grid[:no].reshape(1, 1, Ox, Oy, Oz), 3, stride=1, padding=1)[0, 0]
    gblk = goct.reshape(Bx, 2, By, 2, Bz, 2).amax(dim=(1, 3, 5))
    return gblk.reshape(-1) > 0.5


def _block_centers(vol: TSDFVolume, bs: int) -> torch.Tensor:
    """World coordinates (Bx, By, Bz, 3) of each block's center."""
    X, Y, Z = vol.dims
    b = _voxel_grid(X // bs, Y // bs, Z // bs, vol.tsdf.device).to(torch.float32)
    return torch.addcmul(vol.origin, b * bs + (bs - 1) / 2.0, _full(_scalars(vol)[0], b))


def integrate_sparse(vol: TSDFVolume, depth, intr, T_cw, max_weight: float = 64.0, depth_max: float = 4.0,
                     block_size: int = 8, max_blocks: int = 1024, carve: bool = False,
                     gate=None) -> TSDFVolume:
    """Block-sparse active-band integration: select up to `max_blocks`
    blocks of block_size^3 voxels that the frame's truncation band touches
    (nearest first on overflow), and run `integrate`'s per-voxel update on
    their voxels only. The volume's tensors are updated in place (the
    returned volume shares them): copying a 512^3 volume per frame would
    cost more than the update.

    carve=False selects only blocks intersecting the truncation band, so
    free space in front of the surface keeps weight 0; carve=True also marks
    every frustum block in front of the surface (dense free-space
    semantics). `gate` (a bool tensor, or None) masks the whole update: the
    KinFu tick passes its tracking-and-motion gate here instead of selecting
    between two full volumes.
    """
    X, Y, Z = vol.dims
    bs = block_size
    if X % bs or Y % bs or Z % bs:
        raise ValueError(f"integrate_sparse: volume {vol.dims} is not a multiple of block_size {bs}")
    Bx, By, Bz = X // bs, Y // bs, Z // bs
    nb = Bx * By * Bz
    R, t = se3.mat_to_rt(T_cw)
    active = _active_blocks(vol, depth, intr, T_cw, depth_max, bs, carve)

    zc = (torch.einsum("ij,xyzj->xyzi", R, _block_centers(vol, bs)) + t)[..., 2].reshape(-1)
    K = min(max_blocks, nb)
    score = torch.where(active, 1e3 - zc, -math.inf)
    top, sel = torch.topk(score, K)
    sel_ok = top > -math.inf
    if gate is not None:
        sel_ok = sel_ok & gate

    dev = vol.tsdf.device
    local = _voxel_grid(bs, bs, bs, dev).reshape(-1, 3)  # (bs^3, 3), z fastest
    blk = torch.stack([sel // (By * Bz), (sel // Bz) % By, sel % Bz], dim=-1)  # (K, 3)
    vox = blk[:, None, :] * bs + local[None]  # (K, bs^3, 3)
    flat = (vox[..., 0] * Y + vox[..., 1]) * Z + vox[..., 2]
    t_old = vol.tsdf.view(-1)[flat]
    w_old = vol.weight.view(-1)[flat]
    t_new, w_new = _fuse(t_old, w_old, vox, vol, depth, intr, T_cw, max_weight, depth_max, sel_ok[:, None])
    vol.tsdf.view(-1)[flat] = t_new
    vol.weight.view(-1)[flat] = w_new
    return vol


def _in_volume(g: torch.Tensor, dims) -> torch.Tensor:
    """Grid coordinates (..., 3) inside [0, n - 1] on every axis."""
    return torch.stack([(g[..., a] >= 0) & (g[..., a] <= n - 1.0) for a, n in enumerate(dims)], dim=-1).all(dim=-1)


def sample_trilinear(vol: TSDFVolume, pts_world: torch.Tensor):
    """Trilinear TSDF sample at world points (..., 3). Returns (value,
    valid), valid where all 8 corners carry weight and the point lies in
    the volume."""
    X, Y, Z = vol.dims
    g = (pts_world - vol.origin) / _scalars(vol)[0]
    gc = torch.stack([g[..., a].clamp(0.0, n - 1.001) for a, n in enumerate(vol.dims)], dim=-1)
    g0 = torch.floor(gc)
    f = gc - g0
    gi = g0.long()
    base = (gi[..., 0] * Y + gi[..., 1]) * Z + gi[..., 2]
    c = torch.arange(8, device=g.device)  # corner (dx, dy, dz) = bits (2, 1, 0), dz fastest
    idx = base[..., None] + ((c >> 2) * Y + ((c >> 1) & 1)) * Z + (c & 1)  # (..., 8)
    vals = vol.tsdf.reshape(-1)[idx]
    wts = vol.weight.reshape(-1)[idx]
    wx = torch.stack([1.0 - f[..., 0], f[..., 0]], dim=-1)
    wy = torch.stack([1.0 - f[..., 1], f[..., 1]], dim=-1)
    wz = torch.stack([1.0 - f[..., 2], f[..., 2]], dim=-1)
    w8 = (wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]).reshape(f.shape[:-1] + (8,))
    acc = (vals * w8).sum(dim=-1)
    return acc, (wts.amin(dim=-1) > 0) & _in_volume(g, vol.dims)


def sample_nearest(vol: TSDFVolume, pts_world: torch.Tensor):
    """Nearest-voxel TSDF sample at world points (..., 3) -> (value, valid);
    an invalid sample reads 1.0."""
    X, Y, Z = vol.dims
    g = (pts_world - vol.origin) / _scalars(vol)[0]
    gi = torch.round(g).long()
    idx = ((torch.clamp(gi[..., 0], 0, X - 1) * Y + torch.clamp(gi[..., 1], 0, Y - 1)) * Z
           + torch.clamp(gi[..., 2], 0, Z - 1))
    val = vol.tsdf.reshape(-1)[idx]
    has = vol.weight.reshape(-1)[idx] > 0
    return torch.where(has, val, 1.0), has & _in_volume(g, vol.dims)


def sample_gradient(vol: TSDFVolume, pts_world: torch.Tensor) -> torch.Tensor:
    """Central-difference TSDF gradient (surface normal direction)."""
    h = _scalars(vol)[0]
    g = []
    for e in torch.eye(3, dtype=torch.float32, device=pts_world.device) * h:  # no item assignment: a host copy
        g.append(sample_trilinear(vol, pts_world + e)[0] - sample_trilinear(vol, pts_world - e)[0])
    g = torch.stack(g, dim=-1)
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-9)


def coarse_steps_for(trunc_dist: float, depth_min: float = 0.1, depth_max: float = 4.0) -> int:
    """Minimum coarse raycast step count so the coarse step stays below
    trunc_dist (the band-cannot-be-skipped invariant)."""
    return int(math.ceil((depth_max - depth_min) / max(trunc_dist, 1e-6))) + 1


def _camera_rays(intr, T_cw, H: int, W: int):
    """World-frame ray directions (H, W, 3) at unit camera z, and the
    camera center."""
    R_wc, t_wc = se3.mat_to_rt(se3.inverse(T_cw))
    v, u = pixel_grid(H, W, intr.device)
    dirs_cam = torch.stack([(u - intr[2]) / intr[0], (v - intr[3]) / intr[1], torch.ones_like(u)], dim=-1)
    return torch.einsum("ij,hwj->hwi", R_wc, dirs_cam), t_wc


def _fine_pass(vol, origin, dirs, zp, zc, n_fine: int):
    """n_fine nearest samples inside [zp, zc] per ray: returns (the first
    +/- crossing, linearly interpolated; whether the ray has one)."""
    tf = (torch.arange(n_fine, dtype=torch.float32, device=zp.device) + 0.5) / n_fine
    zf = torch.addcmul(zp[None], tf[:, None, None], (zc - zp)[None])  # (F, H, W)
    ff, okf = sample_nearest(vol, torch.addcmul(origin, dirs[None], zf[..., None]))
    ff_prev = torch.cat([torch.ones_like(ff[:1]), ff[:-1]])
    okf_prev = torch.cat([torch.zeros_like(okf[:1]), okf[:-1]])
    crossf = okf & okf_prev & (ff_prev > 0) & (ff < 0)
    first = crossf.to(torch.uint8).argmax(dim=0, keepdim=True)  # the first crossing, as jnp.argmax
    fi = torch.gather(ff, 0, first)[0]
    fp = torch.gather(ff_prev, 0, first)[0]
    dzf = (zc - zp) / n_fine
    z0 = torch.gather(zf, 0, first)[0] - dzf
    denom = fp - fi
    big = torch.abs(denom) > 1e-9
    alpha = torch.where(big, fp / torch.where(big, denom, 1.0), 0.0)
    return torch.addcmul(z0, alpha, dzf), crossf.any(dim=0)


def _screen_normals(pts_world, dirs):
    """Cross of the point map's edge-replicated forward differences,
    oriented against the viewing ray."""
    def fdiff(a, dim):
        d = torch.diff(a, dim=dim)
        return torch.cat([d, d.narrow(dim, d.shape[dim] - 1, 1)], dim=dim)

    n = torch.linalg.cross(fdiff(pts_world, 0), fdiff(pts_world, 1), dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    flip = torch.sign(torch.sum(n * dirs, dim=-1, keepdim=True))
    return -n * torch.where(flip == 0, 1.0, flip)


def _to_camera(T_cw, pts_world, normals_world, valid):
    R_cw, t_cw = se3.mat_to_rt(T_cw)
    pts_cam = torch.einsum("ij,hwj->hwi", R_cw, pts_world) + t_cw
    normals_cam = torch.einsum("ij,hwj->hwi", R_cw, normals_world)
    return pts_cam * valid[..., None], torch.where(valid[..., None], normals_cam, 0.0), valid


def _min_filter3(a: torch.Tensor) -> torch.Tensor:
    """3x3 'SAME' min over (H, W), +inf outside."""
    return -F.max_pool2d(-a[None, None], 3, stride=1, padding=1)[0, 0]


def _max_filter3(a: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(a[None, None], 3, stride=1, padding=1)[0, 0]


def raycast(vol: TSDFVolume, intr, T_cw, shape=(120, 160), n_steps: int = 192, depth_min: float = 0.1,
            depth_max: float = 4.0, n_coarse: int | None = None, normals: str = "auto",
            coarse_sub: int | None = None, n_fine: int = 12):
    """March all camera rays through the volume, find the first +/- zero
    crossing, interpolate the hit (RaycastInvoker, tsdf.cpp:337). Returns
    (points (H, W, 3) camera frame, normals (H, W, 3) camera frame, valid).

    A coarse pass at a step below trunc_dist brackets each ray's crossing
    (`n_coarse` defaults to what `coarse_steps_for` requires), on a
    `coarse_sub`-subsampled ray grid widened by a 3x3 dilation, then a fine
    pass of n_fine samples inside the bracket. normals: 'gradient' (the
    trilinear TSDF gradient at the hit), 'screen' (from the point map), or
    'auto' (gradient up to 8M voxels)."""
    n_vox = math.prod(vol.dims)
    if n_coarse is None:
        n_coarse = min(n_steps, max(16, n_steps // 4))
        n_coarse = min(n_steps, max(n_coarse, coarse_steps_for(float(vol.trunc_dist), depth_min, depth_max)))
    if normals == "auto":
        normals = "gradient" if n_vox <= 8 * 1024 ** 2 else "screen"
    if coarse_sub is None:
        coarse_sub = 4 if (n_vox > 256 ** 3 and shape[0] % 4 == 0 and shape[1] % 4 == 0) else 2
    return _raycast_impl(vol, intr, T_cw, tuple(shape), depth_min, depth_max, int(n_coarse), normals,
                         int(coarse_sub), int(n_fine))


def _raycast_impl(vol, intr, T_cw, shape, depth_min, depth_max, n_coarse, normals, coarse_sub, n_fine):
    H, W = shape
    dirs, origin = _camera_rays(intr, T_cw, H, W)

    # coarse pass on a cs-subsampled ray grid
    cs = coarse_sub if (H % coarse_sub == 0 and W % coarse_sub == 0) else 1
    Hc, Wc = H // cs, W // cs
    dirs_lo = dirs[::cs, ::cs]
    dz = (depth_max - depth_min) / n_coarse
    zs = torch.addcmul(_full(depth_min, dirs), torch.arange(n_coarse, device=dirs.device) + 0.5,
                       _full(dz, dirs))  # (C,)
    f, ok = sample_nearest(vol, torch.addcmul(origin, dirs_lo[None], zs[:, None, None, None]))
    f_prev = torch.cat([torch.ones((1, Hc, Wc), device=f.device), f[:-1]])
    ok_prev = torch.cat([torch.zeros((1, Hc, Wc), dtype=torch.bool, device=f.device), ok[:-1]])
    crossing = ok & ok_prev & (f_prev > 0) & (f < 0)
    valid_lo = crossing.any(dim=0)
    first = crossing.to(torch.uint8).argmax(dim=0)
    zc_lo = zs[first]
    zp_lo = zs[torch.clamp(first - 1, min=0)]
    if cs > 1:
        zp_d = _min_filter3(torch.where(valid_lo, zp_lo, math.inf))
        zc_d = _max_filter3(torch.where(valid_lo, zc_lo, -math.inf))
        valid_d = zc_d > -math.inf

        def rep(a):
            return a.repeat_interleave(cs, 0).repeat_interleave(cs, 1)

        valid = rep(valid_d)
        own = rep(valid_lo)
        zp = torch.where(valid, rep(torch.where(valid_d, zp_d, 0.0)), 0.0)
        zc = torch.where(valid, rep(torch.where(valid_d, zc_d, 0.0)), 0.0)
        zp_own = rep(torch.where(valid_lo, 0.5 * (zp_lo + zc_lo), 0.0))
    else:
        valid = own = valid_lo
        zp, zc = zp_lo, zc_lo
        zp_own = 0.5 * (zp_lo + zc_lo)

    zhit_f, has_f = _fine_pass(vol, origin, dirs, zp, zc, n_fine)
    # a ray with no fine crossing falls back to its OWN coarse bracket's
    # midpoint; rays valid only through the dilation need a fine crossing
    zhit = torch.where(valid & has_f, zhit_f, torch.where(own & valid, zp_own, 0.0))
    valid = valid & (has_f | own)

    pts_world = torch.addcmul(origin, dirs, zhit[..., None])
    nw = sample_gradient(vol, pts_world) if normals == "gradient" else _screen_normals(pts_world, dirs)
    return _to_camera(T_cw, pts_world, nw, valid & (zhit > 0))


def raycast_splat(vol: TSDFVolume, intr, T_cw, shape=(480, 640), depth_min: float = 0.1, depth_max: float = 4.0,
                  n_fine: int = 16, paint_sub: int = 4, stamp: int = 10, max_surface_blocks: int = 8192,
                  normals: str = "screen"):
    """Splatting raycast: a scatter-min z-buffer over surface blocks
    proposes each ray's bracket, then a short fine pass finds the crossing.

    1. per-block min/max TSDF over weighted voxels, joined over each
       block's 3^3 neighbourhood: blocks whose neighbourhood crosses zero
       are SURFACE blocks;
    2. the nearest `max_surface_blocks` surface blocks are projected and
       splatted (stamp x stamp, trimmed to the block's projected radius)
       into (H/paint_sub, W/paint_sub) z-buffers of their near (z - r) and
       far (z + r) extents;
    3. 3x3 dilation and upsampling give each ray a bracket; the fine pass
       samples n_fine points in it.
    Reference role: RaycastInvoker (rgbd/src/tsdf.cpp:337)."""
    H, W = shape
    X, Y, Z = vol.dims
    bs = 8
    Bx, By, Bz = X // bs, Y // bs, Z // bs
    vs, trunc = (_f32(x) for x in _scalars(vol))
    r_b = vs * _f32(bs) * _f32(0.8660254)  # block bounding-sphere radius, float32

    # 1. surface blocks; unweighted voxels read +9 for the min and -9 for the max
    has = vol.weight > 0
    mn = torch.where(has, vol.tsdf, 9.0).reshape(Bx, bs, By, bs, Bz, bs).amin(dim=(1, 3, 5))
    mx = torch.where(has, vol.tsdf, -9.0).reshape(Bx, bs, By, bs, Bz, bs).amax(dim=(1, 3, 5))
    del has
    mn3 = -F.max_pool3d(-mn[None, None], 3, stride=1, padding=1)[0, 0]
    mx3 = F.max_pool3d(mx[None, None], 3, stride=1, padding=1)[0, 0]
    surf = (mn3 < 0) & (mx3 > 0) & (mn < 8.0)

    # 2. project and select the nearest
    R_cw, t_cw = se3.mat_to_rt(T_cw)
    cc = torch.einsum("ij,xyzj->xyzi", R_cw, _block_centers(vol, bs)) + t_cw
    zb = cc[..., 2].reshape(-1)
    zbs = torch.clamp(zb, min=1e-6)
    ub = torch.addcmul(intr[2], cc[..., 0].reshape(-1) / zbs, intr[0])
    vb = torch.addcmul(intr[3], cc[..., 1].reshape(-1) / zbs, intr[1])
    ok_b = (surf.reshape(-1) & (zb > depth_min) & (zb < float(_f32(depth_max) + r_b))
            & (ub > -64) & (ub < W + 64) & (vb > -64) & (vb < H + 64))
    K = min(max_surface_blocks, Bx * By * Bz)
    top, selb = torch.topk(torch.where(ok_b, 1e3 - zb, -math.inf), K)
    s_ok = top > -math.inf
    su = ub[selb] / paint_sub
    sv = vb[selb] / paint_sub
    sz = zb[selb]

    # 3. paint the near and far z-buffers
    Hp, Wp = H // paint_sub, W // paint_sub
    dev = zb.device
    o = torch.arange(stamp, device=dev) - stamp // 2
    oy, ox = o[:, None].expand(stamp, stamp), o[None, :].expand(stamp, stamp)
    py = torch.round(sv).long()[:, None, None] + oy[None]
    px = torch.round(su).long()[:, None, None] + ox[None]
    # trim each stamp to the block's projected radius, or a near block's z
    # bleeds onto far-surface pixels it does not cover
    r_px = (intr[0] * float(r_b) / torch.clamp(sz, min=1e-3)) / paint_sub + 1.0
    rr2 = (oy * oy + ox * ox)[None].to(torch.float32)
    pin = ((py >= 0) & (py < Hp) & (px >= 0) & (px < Wp) & s_ok[:, None, None]
           & (rr2 <= (r_px[:, None, None] ** 2)))
    pidx = torch.where(pin, py * Wp + px, Hp * Wp).reshape(-1)
    zval = (sz - float(r_b))[:, None, None].expand(K, stamp, stamp).reshape(-1)
    zbuf = torch.full((Hp * Wp + 1,), math.inf, device=dev).scatter_reduce_(0, pidx, zval, "amin")
    zbuf = _min_filter3(zbuf[:-1].reshape(Hp, Wp))
    # far bound: oblique surfaces span many blocks in depth under one pixel
    zfv = (sz + float(r_b))[:, None, None].expand(K, stamp, stamp).reshape(-1)
    zfar = torch.full((Hp * Wp + 1,), -math.inf, device=dev).scatter_reduce_(0, pidx, zfv, "amax")
    zfar = _max_filter3(zfar[:-1].reshape(Hp, Wp))
    zmin = zbuf.repeat_interleave(paint_sub, 0).repeat_interleave(paint_sub, 1)
    zmax = zfar.repeat_interleave(paint_sub, 0).repeat_interleave(paint_sub, 1)
    have = torch.isfinite(zmin)
    zp = torch.where(have, torch.clamp(zmin, min=depth_min), 0.0)
    # span capped so the fine step stays below the truncation distance
    span = torch.clamp(zmax - zp, min=float(_f32(2) * r_b + _f32(2) * vs), max=float(_f32(n_fine * 0.8) * trunc))
    zc = torch.where(have, zp + span, 0.0)

    # 4. fine pass
    dirs, origin = _camera_rays(intr, T_cw, H, W)
    zhit, has_f = _fine_pass(vol, origin, dirs, zp, zc, n_fine)
    valid = have & has_f & (zhit > 0)
    pts_world = torch.addcmul(origin, dirs, zhit[..., None])
    nw = sample_gradient(vol, pts_world) if normals == "gradient" else _screen_normals(pts_world, dirs)
    return _to_camera(T_cw, pts_world, nw, valid)


def extract_points(vol: TSDFVolume, max_points: int = 65536):
    """Zero-crossing voxel extraction (fetchPointsNormals-analog): voxels
    whose tsdf changes sign against the +x/+y/+z neighbour (wrapping, as
    the JAX version's roll), interpolated. Returns (points (N, 3) world,
    normals (N, 3), valid (N,)) with N = max_points."""
    t, w = vol.tsdf, vol.weight
    base = _voxel_grid(*vol.dims, t.device).to(torch.float32)
    pts, crosses = [], []
    for axis in range(3):
        tn = torch.roll(t, -1, axis)
        wn = torch.roll(w, -1, axis)
        big = torch.abs(t - tn) > 1e-9
        cross = (w > 0) & (wn > 0) & (torch.sign(t) != torch.sign(tn)) & big
        alpha = torch.where(cross, t / torch.where(big, t - tn, 1.0), 0.0)
        p = base.clone()
        p[..., axis] = p[..., axis] + alpha
        pts.append(torch.where(cross[..., None], p, -1.0).reshape(-1, 3))
        crosses.append(cross.reshape(-1))
    allp = torch.cat(pts)
    allv = torch.cat(crosses)
    idx = torch.argsort(~allv, stable=True)[:max_points]  # crossings first, in voxel order, as lax.top_k
    valid = allv[idx]
    world = torch.addcmul(vol.origin, allp[idx], _full(_scalars(vol)[0], allp))
    normals = sample_gradient(vol, world)
    return world * valid[:, None], normals * valid[:, None], valid
