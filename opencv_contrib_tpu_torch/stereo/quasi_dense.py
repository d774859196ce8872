"""Quasi-dense stereo: sparse seeds grown to a quasi-dense disparity map
(the port of opencv_contrib_tpu/stereo/quasi_dense.py).

Reference anchor: stereo/src/quasi_dense_stereo.cpp
(QuasiDenseStereo::process: sparse texture seeds, best-first region
growing with ZNCC validation and disparity-gradient limits,
quasi_dense_stereo.hpp:96,164).

As in the twin, the reference's priority-queue best-first growth becomes
synchronous wavefront sweeps over a precomputed ZNCC volume: the ZNCC of
every pixel at every integer disparity (the box filters of all D + 1
shifted windows in one separable pass), then each sweep lets every
unassigned pixel adopt the best neighbouring disparity (+-1) whose ZNCC
passes the gate, in the twin's neighbour order with its strict `>`. The
sweeps step in Python with no host read.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.stereo.matching import _box_maps, block_match


def zncc_volume(left, right, max_disp: int, radius: int = 2):
    """(D+1, H, W) ZNCC between left windows and right windows shifted by
    each integer disparity (the right image's columns x - d, clamped): the
    windows are shift-consistent by construction."""
    H, W = left.shape
    n = max_disp + 1
    ml, mll = _box_maps(torch.stack([left, left * left]), radius)
    vl = torch.clamp(mll - ml * ml, min=1e-6)
    d = torch.arange(n, device=left.device)[:, None]
    xr = torch.clamp(torch.arange(W, device=left.device)[None, :] - d, 0, W - 1)  # (n, W)
    r = right[:, xr].permute(1, 0, 2)  # (n, H, W)
    means = _box_maps(torch.cat([r, left[None] * r, r * r]), radius)
    mr, mlr, mrr = means[:n], means[n:2 * n], means[2 * n:]
    cov = mlr - ml * mr
    vr = torch.clamp(mrr - mr * mr, min=1e-6)
    return cov / torch.sqrt(vl * vr)


def grow(zvol, seed_disp, seed_valid, n_sweeps: int = 48, zncc_thresh: float = 0.6):
    """Wavefront growth from seeds over the ZNCC volume. Disparities are
    integer indices into zvol. Returns (disp, valid)."""
    D1, H, W = zvol.shape
    flat = zvol.reshape(D1, H * W)
    disp, valid = seed_disp.to(torch.int32), seed_valid
    neg_inf = torch.full((H, W), float("-inf"), dtype=zvol.dtype, device=zvol.device)
    for _ in range(n_sweeps):
        best_z = torch.where(valid, torch.full_like(neg_inf, 2.0), neg_inf)
        best_d = disp
        p_d = torch.nn.functional.pad(disp, (1, 1, 1, 1))
        p_v = torch.nn.functional.pad(valid, (1, 1, 1, 1))
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nd = p_d[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            nv = p_v[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            for dd in (-1, 0, 1):
                cand = torch.clamp(nd + dd, 0, D1 - 1)
                z = torch.gather(flat, 0, cand.reshape(1, -1).to(torch.int64)).reshape(H, W)
                score = torch.where(nv & (z > zncc_thresh), z, neg_inf)
                upd = (~valid) & (score > best_z)
                best_z = torch.where(upd, score, best_z)
                best_d = torch.where(upd, cand, best_d)
        disp, valid = best_d, valid | (best_z > float("-inf"))
    return disp, valid


def quasi_dense_stereo(left, right, max_disp: int = 32, seed_stride: int = 8,
                       zncc_thresh: float = 0.6, n_sweeps: int = 48, radius: int = 2):
    """Full quasi-dense pipeline (QuasiDenseStereo::process): block-matched
    seeds on a sparse grid (high-confidence only) -> ZNCC-gated growth.
    Returns (disp (H, W) int32, valid (H, W))."""
    left = torch.as_tensor(left).to(torch.float32)
    right = torch.as_tensor(right).to(torch.float32)
    disp_bm, conf = block_match(left, right, max_disp=max_disp)
    H, W = left.shape
    zvol = zncc_volume(left, right, max_disp, radius)
    d_int = torch.clamp(torch.round(disp_bm).to(torch.int32), 0, max_disp)
    z_at = torch.gather(zvol.reshape(max_disp + 1, H * W), 0, d_int.reshape(1, -1).to(torch.int64)).reshape(H, W)
    grid = torch.zeros((H, W), dtype=torch.bool, device=left.device)
    grid[::seed_stride, ::seed_stride].fill_(True)
    seeds = grid & conf & (z_at > 0.8)
    return grow(zvol, torch.where(seeds, d_int, torch.zeros_like(d_int)), seeds,
                n_sweeps=n_sweeps, zncc_thresh=zncc_thresh)
