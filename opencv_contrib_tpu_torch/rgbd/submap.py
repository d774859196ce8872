"""Submaps and large-scale KinFu (the port of opencv_contrib_tpu/rgbd/submap.py;
submap.hpp :23-119 Submap, :126-167 SubmapManager, shouldCreateSubmap
:218; large_kinfu.cpp LargeKinfuImpl::updateT :214-282).

Each submap is a dense volume in its own frame with a world pose. The
manager is host control flow, as in the reference: every frame reads the
tracking flag (`bool(ok)`) and the camera pose (to decide on a new submap)
back to the host, two synchronisations a frame. Poses of submaps and
their constraints are host numpy arrays; volumes, frames and ICP live on
the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.rgbd import frame as frame_mod
from opencv_contrib_tpu_torch.rgbd import icp as icp_mod
from opencv_contrib_tpu_torch.rgbd import posegraph
from opencv_contrib_tpu_torch.rgbd import tsdf as tsdf_mod
from opencv_contrib_tpu_torch.rgbd.kinfu import _pyr_from
from opencv_contrib_tpu_torch.utils.device import resolve, to_device
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


@dataclass
class Submap:
    """One submap: a dense volume in its own frame and its world pose."""

    index: int
    T_ws: np.ndarray  # submap -> world (4, 4)
    volume: object  # TSDFVolume
    n_frames: int = 0
    constraints: dict = field(default_factory=dict)  # other_idx -> (T_rel, weight)


@dataclass
class LargeKinFuParams:
    intr: np.ndarray
    frame_shape: tuple = (120, 160)
    pyramid_levels: int = 3
    volume_resolution: tuple = (96, 96, 96)
    volume_size: float = 3.0
    depth_max: float = 4.0
    icp_iterations: tuple = (10, 5, 4)
    # a new submap when the camera leaves the active volume's comfortable
    # tracking region (the shouldCreateSubmap analog)
    max_dist_from_center: float = 1.0
    min_frames_per_submap: int = 5


def _host_mul(A: np.ndarray, B: np.ndarray, invert_a: bool = False) -> np.ndarray:
    """A @ B (or A^-1 @ B) of host float32 poses, by the port's se3."""
    a = torch.from_numpy(np.asarray(A, np.float32))
    return ((se3.inverse(a) if invert_a else a) @ torch.from_numpy(np.asarray(B, np.float32))).numpy()


class LargeKinFu:
    """Submap-based large-scale KinectFusion. It runs on the card unless the
    caller passes device='cpu', and raises when asked for a card there is
    none of."""

    def __init__(self, params: LargeKinFuParams, device="cuda"):
        self.p = params
        self.device = resolve(device)
        self.intr = to_device(params.intr, self.device)  # pinned: no stream sync
        self.reset()

    def reset(self):
        self.submaps: list[Submap] = []
        self.T_cw = torch.eye(4, device=self.device)  # world -> camera
        self.frame_count = 0
        self.model_pyr = None
        self._new_submap(np.eye(4, dtype=np.float32))

    # ---- submap management (SubmapManager analog) ----

    def _new_submap(self, T_ws: np.ndarray):
        p = self.p
        vol = tsdf_mod.create(p.volume_resolution, p.volume_size, center=(0.0, 0.0, p.volume_size / 2.0 + 0.5),
                              device=self.device)
        sm = Submap(index=len(self.submaps), T_ws=np.asarray(T_ws, np.float32), volume=vol)
        if self.submaps:
            prev = self.submaps[-1]
            prev.constraints[sm.index] = (_host_mul(prev.T_ws, T_ws, invert_a=True), 1.0)
        self.submaps.append(sm)
        self.active = sm
        return sm

    def _should_create_submap(self) -> bool:
        """The shouldCreateSubmap analog: the camera is too far from the
        active submap's origin (in the submap's frame). Reads the pose back."""
        T_sc = _host_mul(self.active.T_ws, se3.inverse(self.T_cw).cpu().numpy(), invert_a=True)
        dist = np.linalg.norm(T_sc[:3, 3])
        return self.active.n_frames >= self.p.min_frames_per_submap and dist > self.p.max_dist_from_center

    # ---- per-frame loop (LargeKinfuImpl::updateT analog) ----

    @f32_matmuls
    def update(self, depth) -> bool:
        p = self.p
        pyr = frame_mod.make_frame(to_device(depth, self.device), self.intr, levels=p.pyramid_levels)
        if self.frame_count == 0:
            self._integrate_active(pyr[0].depth)
            self.model_pyr = self._raycast_active()
            self.frame_count = 1
            self.active.n_frames = 1
            return True

        T_rel, ok, _ = icp_mod.estimate_transform(pyr, self.model_pyr, self.intr, iterations=p.icp_iterations)
        if not bool(ok):
            return False
        self.T_cw = se3.inverse(T_rel) @ self.T_cw
        if self._should_create_submap():  # a new submap anchored at the current camera pose
            self._new_submap(se3.inverse(self.T_cw).cpu().numpy())
        self._integrate_active(pyr[0].depth)
        self.model_pyr = self._raycast_active()
        self.frame_count += 1
        self.active.n_frames += 1
        return True

    def _cam_in_submap(self) -> torch.Tensor:
        """World -> camera composed into the active submap's frame:
        submap -> camera."""
        return self.T_cw @ to_device(self.active.T_ws, self.device)

    def _integrate_active(self, depth):
        self.active.volume = tsdf_mod.integrate(self.active.volume, depth, self.intr, self._cam_in_submap(),
                                                depth_max=self.p.depth_max)

    def _raycast_active(self):
        p = self.p
        pts, nrm, valid = tsdf_mod.raycast(self.active.volume, self.intr, self._cam_in_submap(),
                                           shape=p.frame_shape, depth_max=p.depth_max)
        return _pyr_from(pts, nrm, valid, p.pyramid_levels)

    # ---- loop closure / pose graph (MapToPoseGraph analog) ----

    def add_loop_constraint(self, i: int, j: int, T_rel: np.ndarray, weight: float = 1.0):
        """Register an inter-submap constraint (e.g. from a relocalisation
        match): T_rel = submap_j in submap_i's frame."""
        self.submaps[i].constraints[j] = (np.asarray(T_rel, np.float32), weight)

    @f32_matmuls
    def optimize_pose_graph(self, n_iters: int = 30):
        """Build the submap pose graph and optimise it (MapToPoseGraph +
        PoseGraph::optimize, large_kinfu.cpp:282). Returns the (initial,
        final) costs as floats."""
        if len(self.submaps) < 2:
            return 0.0, 0.0
        poses = np.stack([sm.T_ws for sm in self.submaps])
        eij, eT = [], []
        for sm in self.submaps:
            for j, (T_rel, _) in sm.constraints.items():
                eij.append([sm.index, j])
                eT.append(T_rel)
        g = posegraph.make_graph(poses, np.array(eij), np.stack(eT), device=self.device)
        g2, costs = posegraph.optimize(g, n_iters=n_iters)
        for sm, T in zip(self.submaps, g2.poses.cpu().numpy()):
            sm.T_ws = T.astype(np.float32)
        costs = costs.cpu()
        return float(costs[0]), float(costs[1])

    @property
    def pose(self) -> np.ndarray:
        return se3.inverse(self.T_cw).cpu().numpy()
