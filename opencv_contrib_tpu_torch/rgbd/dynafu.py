"""DynaFu: non-rigid dense fusion — the port of opencv_contrib_tpu/rgbd/dynafu.py
(rgbd/src/dynafu.cpp DynaFuImpl::updateT, experimental upstream): a
canonical TSDF volume plus a warp field; each frame (1) is taken at the
identity pose (camera static, scene deforming: the reference's demo
setting), (2) fits the warp field so that the warped canonical surface
matches the live depth, (3) integrates the live depth into the CANONICAL
volume through the inverse warp, approximated as warp^-1(x) ~ x - (warp(x)
- x) for small deformations.

Built from rgbd.tsdf (canonical volume, raycast) and rgbd.warpfield (DQB
nodes, the autograd fit). It runs on the card unless the caller passes
device='cpu', and raises when asked for a card there is none of. `update`
reads one value back to the host a frame, its tracking flag (the JAX
package's `bool(res < 0.05)`); the first frame also reads the surface
points to place the nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.rgbd import tsdf as tsdf_mod
from opencv_contrib_tpu_torch.rgbd import warpfield as wf_mod
from opencv_contrib_tpu_torch.rgbd.frame import compute_normals, depth_to_points
from opencv_contrib_tpu_torch.utils.device import resolve, to_device
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


class DynaFu:
    """Minimal DynaFu loop: identity rigid pose, a non-rigid fit a frame,
    canonical integration."""

    def __init__(self, intr, volume_resolution=(64, 64, 64), volume_size: float = 2.0,
                 volume_center=(0.0, 0.0, 1.5), n_nodes: int = 64, node_sigma: float = 0.15,
                 frame_shape=(120, 160), device="cuda"):
        self.device = resolve(device)
        self.intr = torch.as_tensor(np.asarray(intr, np.float32)).to(self.device)
        self.volume = tsdf_mod.create(volume_resolution, volume_size, volume_center, device=self.device)
        self.frame_shape = tuple(frame_shape)
        self.n_nodes = n_nodes
        self.node_sigma = node_sigma
        self.warp = None
        self.nbrs = None
        self.frame_count = 0
        self._eye = torch.eye(4, device=self.device)

    def _init_nodes(self, pts, valid):
        """Sample warp nodes from the first surface (warpfield node init):
        n_nodes of the valid points, evenly spaced in raster order."""
        p = pts.reshape(-1, 3).cpu().numpy()
        v = valid.reshape(-1).cpu().numpy()
        cand = p[v]
        idx = np.linspace(0, len(cand) - 1, self.n_nodes).astype(int)
        self.warp = wf_mod.make_warpfield(torch.from_numpy(cand[idx]).to(self.device), sigma=self.node_sigma)
        self.nbrs = wf_mod.node_neighbors(self.warp.nodes)

    def _canonical(self):
        """The canonical surface seen from the identity pose."""
        return tsdf_mod.raycast(self.volume, self.intr, self._eye, self.frame_shape)

    @f32_matmuls
    def update(self, depth) -> bool:
        depth = to_device(depth, self.device)
        pts = depth_to_points(depth, self.intr)
        valid = depth > 0
        if self.frame_count == 0:
            self.volume = tsdf_mod.integrate(self.volume, depth, self.intr, self._eye)
            self._init_nodes(pts, valid)
            self.frame_count = 1
            return True

        cpts, _, cvalid = self._canonical()
        normals, _ = compute_normals(pts, valid)
        # correspondences by pixel (projective association at identity pose)
        m = (cvalid & valid).reshape(-1)
        src = cpts.reshape(-1, 3)
        tgt = pts.reshape(-1, 3)
        nrm = normals.reshape(-1, 3)
        w = m.to(torch.float32)
        # fit the warp so that warp(canonical) ~ live (masked point-to-plane)
        self.warp = wf_mod.fit(self.warp, src, tgt, nrm * w[:, None], self.nbrs, iters=40, lr=0.1, lam=0.5)

        warped = wf_mod.warp_points(self.warp, src)
        # residual after the fit (tracking quality)
        res = torch.linalg.norm((warped - tgt) * w[:, None], dim=1).sum() / torch.clamp(w.sum(), min=1)
        # integrate through the inverse warp: a pseudo-depth map of the
        # warped canonical surface fused with the live depth
        z = torch.clamp(warped[:, 2], min=1e-6)
        u = warped[:, 0] / z * self.intr[0] + self.intr[2]
        v = warped[:, 1] / z * self.intr[1] + self.intr[3]
        H, W = self.frame_shape
        ui = torch.clamp(torch.round(u).to(torch.int32), 0, W - 1).long()
        vi = torch.clamp(torch.round(v).to(torch.int32), 0, H - 1).long()
        live_z = depth[vi, ui]
        ok = m & (live_z > 0)
        # back-deformed depth: canonical z + (live z - warped z)
        z_canon = torch.where(ok, src[:, 2] + (live_z - warped[:, 2]), 0.0)
        pseudo = torch.zeros(H * W, device=self.device).scatter_reduce_(0, vi * W + ui, z_canon, "amax",
                                                                       include_self=True)
        pseudo = pseudo.reshape(H, W)
        pseudo = torch.where(pseudo > 0, pseudo, torch.where(valid & ~cvalid, depth, 0.0))
        self.volume = tsdf_mod.integrate(self.volume, pseudo, self.intr, self._eye)
        self.frame_count += 1
        return bool(res < 0.05)

    def get_cloud(self, max_points: int = 16384):
        """Canonical-frame surface (fetchPointsNormals-analog)."""
        return tsdf_mod.extract_points(self.volume, max_points)

    def render_live(self):
        """Raycast the canonical surface and warp it to the live frame."""
        cpts, _, cvalid = self._canonical()
        warped = wf_mod.warp_points(self.warp, cpts.reshape(-1, 3)).reshape(cpts.shape)
        return warped, cvalid
