"""Sparse (hashed-block) TSDF volume (the port of
opencv_contrib_tpu/rgbd/hash_tsdf.py; hash_tsdf.cpp's VolumeUnit map of
blocks allocated along the truncation band, AllocateVolumeUnitsInvoker
:190, per-unit integration, cross-unit raycast).

The unordered map is a fixed-capacity pool: `keys` (N,) int32 packed block
coordinates kept sorted (empty slots hold the largest int32 and sort
last), `coords` (N, 3), `tsdf` / `weight` (N, B, B, B) and `active`.
Allocation dedups the blocks a frame touches by sorting (sort, keep the
first of each run, sort again: every shape is static, so nothing waits for
the host), and a merge keeps the `capacity` smallest keys of pool and
fresh blocks: a full pool evicts its largest keys, as the JAX package
does. Lookup is a binary search (`torch.searchsorted`) over the sorted
keys. Every sort is stable, so equal keys keep their order as `jnp.sort` /
`jnp.argsort` keep it.

`create` keeps `voxel_size` and `trunc_dist` as float32 scalars on the host
(as `tsdf.create` does); divisions by them go through a float32 tensor on
the data's device, which the card divides exactly (a Python scalar would
be turned into a multiplication by its reciprocal there).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.rgbd.frame import pixel_grid
from opencv_contrib_tpu_torch.rgbd.tsdf import _full, _project, _scalars

B = 8  # voxels per block side

_BITS = 10
_OFFSET = 1 << (_BITS - 1)  # block indices in [-512, 512)
_MASK = (1 << _BITS) - 1
_EMPTY_KEY = (1 << 31) - 1


class HashTSDF(NamedTuple):
    keys: torch.Tensor  # (N,) int32 sorted packed block coords (active first)
    coords: torch.Tensor  # (N, 3) int32 block indices (parallel to keys)
    tsdf: torch.Tensor  # (N, B, B, B)
    weight: torch.Tensor  # (N, B, B, B)
    active: torch.Tensor  # (N,) bool
    voxel_size: torch.Tensor  # scalar
    trunc_dist: torch.Tensor  # scalar

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def _pack(coords: torch.Tensor) -> torch.Tensor:
    """Block coordinates (..., 3) -> int32 keys: 10 bits an axis, x highest."""
    c = torch.clamp(coords.to(torch.int32) + _OFFSET, 0, _MASK)
    return (c[..., 0] << (2 * _BITS)) | (c[..., 1] << _BITS) | c[..., 2]


def _unpack(keys: torch.Tensor) -> torch.Tensor:
    return torch.stack([((keys >> (2 * _BITS)) & _MASK) - _OFFSET, ((keys >> _BITS) & _MASK) - _OFFSET,
                        (keys & _MASK) - _OFFSET], dim=-1).to(torch.int32)


def create(capacity: int = 4096, voxel_size: float = 0.02, trunc_dist: float | None = None,
           device="cpu") -> HashTSDF:
    """An empty pool of `capacity` blocks on `device`."""
    if trunc_dist is None:
        trunc_dist = 5.0 * voxel_size
    return HashTSDF(
        keys=torch.full((capacity,), _EMPTY_KEY, dtype=torch.int32, device=device),
        coords=torch.zeros((capacity, 3), dtype=torch.int32, device=device),
        tsdf=torch.zeros((capacity, B, B, B), dtype=torch.float32, device=device),
        weight=torch.zeros((capacity, B, B, B), dtype=torch.float32, device=device),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        voxel_size=torch.tensor(voxel_size, dtype=torch.float32),
        trunc_dist=torch.tensor(trunc_dist, dtype=torch.float32),
    )


def _lookup(keys_sorted: torch.Tensor, query_keys: torch.Tensor):
    """Binary-search lookup: -> (slot indices, found mask)."""
    idx = torch.searchsorted(keys_sorted, query_keys.contiguous())
    idx = torch.clamp(idx, 0, keys_sorted.shape[0] - 1)
    return idx, keys_sorted[idx] == query_keys


def _sort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True)[0]


def allocate(vol: HashTSDF, depth: torch.Tensor, intr: torch.Tensor, T_cw: torch.Tensor,
             depth_max: float = 4.0) -> HashTSDF:
    """Allocate the blocks along the truncation band of the depth frame
    (the AllocateVolumeUnitsInvoker contract): back-project each valid
    pixel at depth - trunc, depth and depth + trunc, collect the blocks
    touched, and merge the new ones into the pool."""
    H, W = depth.shape
    v, u = pixel_grid(H, W, depth.device)
    valid = (depth > 0) & (depth < depth_max)
    R, t = se3.mat_to_rt(se3.inverse(T_cw))
    vs, trunc = _scalars(vol)
    rays = torch.stack([(u - intr[2]) / intr[0], (v - intr[3]) / intr[1], torch.ones_like(u)], dim=-1)
    block_m = _full(np.float32(B) * np.float32(vs), depth)
    empty = torch.full((), _EMPTY_KEY, dtype=torch.int32, device=depth.device)
    cand = []
    for band in (-1.0, 0.0, 1.0):
        d = depth + float(np.float32(band) * np.float32(trunc))
        pw = torch.einsum("ij,hwj->hwi", R, rays * d[..., None]) + t
        cand.append(torch.where(valid, _pack(torch.floor(pw / block_m)), empty).reshape(-1))
    cand = _sort(torch.cat(cand))

    # dedup: keep the first of each run of equal keys, empties sort last
    first = torch.ones_like(cand, dtype=torch.bool)
    first[1:] = cand[1:] != cand[:-1]
    uniq = _sort(torch.where(first, cand, empty))
    # drop the keys the pool holds already
    _, found = _lookup(vol.keys, uniq)
    fresh = _sort(torch.where(~found & (uniq != _EMPTY_KEY), uniq, empty))

    # merge: the n smallest keys of pool + fresh; data re-gathered by key order
    n = vol.capacity
    all_keys = torch.cat([vol.keys, fresh[:n]])
    order = torch.argsort(all_keys, stable=True)[:n]
    merged = all_keys[order]
    from_pool = (order < n)[:, None, None, None]
    pool_idx = torch.clamp(order, 0, n - 1)
    return vol._replace(keys=merged, coords=_unpack(merged),
                        tsdf=torch.where(from_pool, vol.tsdf[pool_idx], 0.0),
                        weight=torch.where(from_pool, vol.weight[pool_idx], 0.0),
                        active=merged != _EMPTY_KEY)


def _block_offsets(device) -> torch.Tensor:
    """(B, B, B, 3) voxel offsets inside a block, float32."""
    a = torch.arange(B, device=device)
    return torch.stack(torch.meshgrid(a, a, a, indexing="ij"), dim=-1).to(torch.float32)


def integrate(vol: HashTSDF, depth: torch.Tensor, intr: torch.Tensor, T_cw: torch.Tensor, max_weight: float = 64.0,
              depth_max: float = 4.0, gate=None) -> HashTSDF:
    """Fuse a depth frame into every active block (per-unit integration):
    every voxel of every block projects into the frame and gathers its
    sample, masked by the block's activity. `gate` (a bool tensor, or None)
    masks the whole update: with it False the volume keeps its values."""
    H, W = depth.shape
    vs, trunc = _scalars(vol)
    R, t = se3.mat_to_rt(T_cw)
    base = vol.coords.to(torch.float32) * B
    pw = (base[:, None, None, None, :] + _block_offsets(depth.device) + 0.5) * vs
    pc = torch.einsum("ij,nabcj->nabci", R, pw) + t
    z, vi, ui, inb = _project(pc, intr, H, W)
    d = depth.reshape(-1)[torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)]
    ok = inb & (d > 0) & (d < depth_max) & vol.active[:, None, None, None]
    sdf = d - z
    within = ok & (sdf > -trunc)
    if gate is not None:
        within = within & gate
    tsdf_new = torch.clamp(sdf / _full(trunc, sdf), -1.0, 1.0)
    w_old = vol.weight
    w_add = within.to(torch.float32)
    fused = torch.where(within, torch.addcmul(vol.tsdf * w_old, tsdf_new, w_add)
                        / torch.clamp(w_old + w_add, min=1.0), vol.tsdf)
    return vol._replace(tsdf=fused, weight=torch.clamp(w_old + w_add, max=max_weight))


def sample(vol: HashTSDF, pts_world: torch.Tensor):
    """Nearest-voxel TSDF sample at world points (..., 3) -> (value, valid)."""
    vox = torch.floor(pts_world / _full(_scalars(vol)[0], pts_world)).to(torch.int32)
    bc = torch.div(vox, B, rounding_mode="floor")
    local = torch.clamp(vox - bc * B, 0, B - 1)
    slot, found = _lookup(vol.keys, _pack(bc))
    flat = ((slot * B + local[..., 0]) * B + local[..., 1]) * B + local[..., 2]
    return vol.tsdf.reshape(-1)[flat], found & (vol.weight.reshape(-1)[flat] > 0)


def raycast(vol: HashTSDF, intr: torch.Tensor, T_cw: torch.Tensor, shape=(120, 160), n_steps: int = 128,
            depth_min: float = 0.2, depth_max: float = 4.0):
    """Fixed-step march with nearest-voxel sampling and a linear
    interpolation of the first +/- zero crossing; every (step, ray) sample
    is looked up at once, then the first crossing is an argmax. Normals are
    central differences of the sampled field. Returns (points_cam,
    normals_cam, valid)."""
    H, W = shape
    dev = T_cw.device
    R_wc, origin = se3.mat_to_rt(se3.inverse(T_cw))
    v, u = pixel_grid(H, W, dev)
    dirs_cam = torch.stack([(u - intr[2]) / intr[0], (v - intr[3]) / intr[1], torch.ones_like(u)], dim=-1)
    dirs = torch.einsum("ij,hwj->hwi", R_wc, dirs_cam)
    dz = (depth_max - depth_min) / n_steps
    zs = torch.addcmul(_full(depth_min, dirs), torch.arange(n_steps, device=dev) + 0.5, _full(dz, dirs))

    f, ok = sample(vol, torch.addcmul(origin, dirs[None], zs[:, None, None, None]))  # (S, H, W)
    f_prev = torch.cat([torch.ones_like(f[:1]), f[:-1]])
    ok_prev = torch.cat([torch.zeros_like(ok[:1]), ok[:-1]])
    crossing = ok & ok_prev & (f_prev > 0) & (f < 0)
    del ok, ok_prev
    valid = crossing.any(dim=0)
    first = crossing.to(torch.uint8).argmax(dim=0, keepdim=True)  # the first crossing, as jnp.argmax
    fi = torch.gather(f, 0, first)[0]
    fp = torch.gather(f_prev, 0, first)[0]
    del f, f_prev, crossing
    first = first[0]
    zc = zs[first]
    zp = zs[torch.clamp(first - 1, min=0)]
    denom = fp - fi
    big = torch.abs(denom) > 1e-9
    alpha = torch.where(big, fp / torch.where(big, denom, 1.0), 0.0)
    zhit = torch.where(valid, torch.addcmul(zp, alpha, zc - zp), 0.0)
    pts_world = torch.addcmul(origin, dirs, zhit[..., None])

    h = _scalars(vol)[0]
    g = []
    for e in torch.eye(3, dtype=torch.float32, device=dev) * h:  # no item assignment: that copies from the host
        g.append(sample(vol, pts_world + e)[0] - sample(vol, pts_world - e)[0])
    g = torch.stack(g, dim=-1)
    normals_world = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-9)
    R_cw, t_cw = se3.mat_to_rt(T_cw)
    pts_cam = torch.einsum("ij,hwj->hwi", R_cw, pts_world) + t_cw
    normals_cam = torch.einsum("ij,hwj->hwi", R_cw, normals_world)
    valid = valid & (zhit > 0)
    return pts_cam * valid[..., None], torch.where(valid[..., None], normals_cam, 0.0), valid


def n_active(vol: HashTSDF) -> int:
    """The number of allocated blocks (reads it back to the host)."""
    return int(vol.active.sum())
