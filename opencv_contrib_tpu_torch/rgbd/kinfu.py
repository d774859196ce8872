"""KinectFusion: the per-frame dense SLAM loop (the port of
opencv_contrib_tpu/rgbd/kinfu.py; kinfu.cpp KinFuImpl::updateT :233-285):
make frame -> (frame 0: integrate) else ICP against the raycast model ->
pose update -> min-movement gate -> integrate -> raycast -> pyramid.

The tick makes no host round trip: the tracking-ok and min-movement gates
are masked selects on the device, as in the JAX version's fused tick, and
`update(depth, sync=False)` returns without reading the tracking flag. The
gated integration updates only the selected blocks of the volume, in place,
instead of selecting between two full volumes. Each stage of the tick runs
inside a `torch.profiler.record_function` range (`kinfu.make_frame`,
`kinfu.icp`, `kinfu.integrate`, `kinfu.raycast`), so that a profile of
`update` attributes host time, device time and launches to the stages.

`HashKinFu` runs the same tick on the hashed-block volume (rgbd/hash_tsdf.py):
allocate along the band, integrate, and a raycast whose maps are decimated
into the model pyramid. It makes no host round trip either.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.rgbd import frame as frame_mod
from opencv_contrib_tpu_torch.rgbd import hash_tsdf as ht
from opencv_contrib_tpu_torch.rgbd import icp as icp_mod
from opencv_contrib_tpu_torch.rgbd import tsdf as tsdf_mod
from opencv_contrib_tpu_torch.rgbd.frame import DepthFrame
from opencv_contrib_tpu_torch.utils.device import resolve, to_device
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


@dataclass
class KinFuParams:
    intr: np.ndarray  # (9,) camera intrinsics
    frame_shape: tuple = (120, 160)
    pyramid_levels: int = 3
    volume_resolution: tuple = (128, 128, 128)
    volume_size: float = 3.0
    # the volume sits in front of the first camera (world = first camera
    # frame), like the reference's volumePose (kinfu.cpp:66)
    volume_center: tuple = (0.0, 0.0, 2.0)
    depth_max: float = 4.0
    icp_iterations: tuple = (10, 5, 4)
    icp_dist_thresh: float = 0.1
    tsdf_max_weight: float = 64.0
    min_translation: float = 0.008  # min-movement gate before re-integration
    min_rotation: float = 0.01
    # block-sparse integration (tsdf.integrate_sparse): the number of 8^3
    # blocks to integrate per frame, or None for the dense path
    sparse_blocks: int | None = None

    @staticmethod
    def default(intr, frame_shape=(120, 160)):
        return KinFuParams(intr=np.asarray(intr, np.float32), frame_shape=frame_shape)

    @staticmethod
    def coarse(intr, frame_shape=(120, 160)):
        return KinFuParams(intr=np.asarray(intr, np.float32), frame_shape=frame_shape,
                           volume_resolution=(64, 64, 64), pyramid_levels=3, icp_iterations=(5, 3, 2))


def _pyr_from(pts, nrm, valid, levels: int):
    """The model pyramid of raycast maps: 2x decimations, made contiguous
    for the ICP kernel."""
    frames = []
    for _ in range(levels):
        frames.append(DepthFrame(depth=pts[..., 2], points=pts, normals=nrm, valid=valid))
        pts, nrm, valid = (a[::2, ::2].contiguous() for a in (pts, nrm, valid))
    return tuple(frames)


def _raycast_pyramid(volume, intr, T_cw, shape, levels, depth_max, n_coarse=None):
    """The model pyramid at pose T_cw: above 256^3 voxels (dims divisible by
    8) the splatting raycast, otherwise the marching one; levels are 2x
    decimations of the raycast maps, made contiguous for the ICP kernel.

    Normals are the TSDF gradient at every size (RaycastInvoker,
    tsdf.cpp:337). Here the port departs from the JAX package on purpose:
    the JAX package takes screen-space normals with the splat raycast, and
    with them its own 8-frame VGA orbit drifts past the reference gate from
    288^3 up (0.032 rad at 288^3, 0.069 rad at 384^3 on the CPU; the port
    with screen-space normals drifts the same on the same frames). With
    gradient normals both stay below 0.005 rad
    (scripts/kinfu_normals_drift.py)."""
    dims = volume.dims
    if int(np.prod(dims)) > 256 ** 3 and all(d % 8 == 0 for d in dims):
        pts, nrm, valid = tsdf_mod.raycast_splat(volume, intr, T_cw, shape=shape, depth_max=depth_max,
                                                 n_fine=10, stamp=8, normals="gradient")
    else:
        pts, nrm, valid = tsdf_mod.raycast(volume, intr, T_cw, shape=shape, depth_max=depth_max,
                                           n_coarse=n_coarse, n_fine=12, normals="gradient")
    return _pyr_from(pts, nrm, valid, levels)


class KinFu:
    """KinFu facade (reset / update / pose / get_cloud / render_depth). It
    runs on the card unless the caller passes device='cpu', and raises when
    asked for a card there is none of. The volume is updated in place by
    the sparse path."""

    def __init__(self, params: KinFuParams, device="cuda"):
        self.p = params
        self.device = resolve(device)
        # the coarse raycast step must stay below trunc_dist (5 voxels)
        trunc = 5.0 * params.volume_size / params.volume_resolution[0]
        self._n_coarse = tsdf_mod.coarse_steps_for(trunc, 0.1, params.depth_max)
        self.intr = torch.as_tensor(np.asarray(params.intr, np.float32)).to(self.device)
        self.reset()

    def reset(self):
        p = self.p
        self.volume = tsdf_mod.create(p.volume_resolution, p.volume_size, p.volume_center, device=self.device)
        self.T_cw = torch.eye(4, device=self.device)  # world -> camera of the CURRENT frame
        self.frame_count = 0
        self.model_pyr = None  # raycast model pyramid at the previous pose
        self.last_ok = None

    @property
    def pose(self) -> np.ndarray:
        """Camera -> world pose of the latest tracked frame (getPose)."""
        return se3.inverse(self.T_cw).cpu().numpy()

    def _integrate(self, depth, T_cw, gate=None):
        p = self.p
        if p.sparse_blocks is None:
            return tsdf_mod.integrate(self.volume, depth, self.intr, T_cw, max_weight=p.tsdf_max_weight,
                                      depth_max=p.depth_max, gate=gate)
        return tsdf_mod.integrate_sparse(self.volume, depth, self.intr, T_cw, max_weight=p.tsdf_max_weight,
                                         depth_max=p.depth_max, max_blocks=p.sparse_blocks, gate=gate)

    def _model(self, T_cw):
        p = self.p
        return _raycast_pyramid(self.volume, self.intr, T_cw, p.frame_shape, p.pyramid_levels, p.depth_max,
                                self._n_coarse)

    @f32_matmuls
    def update(self, depth, sync: bool = True) -> bool:
        """One frame tick (updateT, kinfu.cpp:233). Returns False on
        tracking failure (the caller decides to reset). With sync=False the
        tracking flag is not read back, so ticks queue on the device without
        waiting; it stays in `last_ok` as a device tensor. A failed frame
        changes neither the pose nor the volume either way."""
        p = self.p
        with record_function("kinfu.make_frame"):
            depth = to_device(depth, self.device)
            pyr = frame_mod.make_frame(depth, self.intr, levels=p.pyramid_levels)
        if self.frame_count == 0:
            with record_function("kinfu.integrate"):
                self.volume = self._integrate(pyr[0].depth, self.T_cw)
            with record_function("kinfu.raycast"):
                self.model_pyr = self._model(self.T_cw)
            self.frame_count = 1
            self.last_ok = torch.ones((), dtype=torch.bool, device=self.device)
            return True
        with record_function("kinfu.icp"):
            T_rel, ok, _ = icp_mod.estimate_transform(pyr, self.model_pyr, self.intr,
                                                      iterations=p.icp_iterations, dist_thresh=p.icp_dist_thresh)
            T_cw = torch.where(ok, se3.inverse(T_rel) @ self.T_cw, self.T_cw)
            delta = se3.log_se3(T_rel)
            moved = ((torch.linalg.norm(delta[3:]) > p.min_translation)
                     | (torch.linalg.norm(delta[:3]) > p.min_rotation))
        with record_function("kinfu.integrate"):
            self.volume = self._integrate(pyr[0].depth, T_cw, gate=ok & moved)
        with record_function("kinfu.raycast"):
            model = self._model(T_cw)
            self.model_pyr = tuple(DepthFrame(*(torch.where(ok, a, b) for a, b in zip(new, old)))
                                   for new, old in zip(model, self.model_pyr))
        self.T_cw = T_cw
        self.frame_count += 1
        self.last_ok = ok
        return bool(ok) if sync else True

    def get_cloud(self, max_points: int = 65536):
        """World-frame surface points + normals (getCloud)."""
        return tsdf_mod.extract_points(self.volume, max_points)

    def render_depth(self) -> torch.Tensor:
        """Raycast depth at the current pose (render-analog)."""
        pts, _, valid = tsdf_mod.raycast(self.volume, self.intr, self.T_cw, shape=self.p.frame_shape,
                                         depth_max=self.p.depth_max)
        return pts[..., 2] * valid


class HashKinFu:
    """KinFu on the hashed-block volume: the reference's hashTSDFParams
    preset (kinfu.hpp:19, hash_tsdf.cpp:81-91), for unbounded scenes, with
    blocks allocated along the truncation band every frame. Same tick
    contract as KinFu (update -> bool, reset, pose). The voxel is
    volume_size / volume_resolution[0]. A frame that fails to track still
    allocates its blocks (as the JAX version does) but integrates nothing
    and keeps the pose and the model."""

    def __init__(self, params: KinFuParams, capacity: int = 16384, device="cuda"):
        self.p = params
        self.capacity = capacity
        self.device = resolve(device)
        self.intr = to_device(params.intr, self.device)  # pinned: no stream sync
        self.reset()

    def reset(self):
        vs = self.p.volume_size / self.p.volume_resolution[0]
        self.volume = ht.create(self.capacity, voxel_size=float(vs), device=self.device)
        self.T_cw = torch.eye(4, device=self.device)
        self.frame_count = 0
        self.model_pyr = None
        self.last_ok = None

    @property
    def pose(self) -> np.ndarray:
        return se3.inverse(self.T_cw).cpu().numpy()

    def _fuse(self, depth, T_cw, gate=None):
        p = self.p
        with record_function("kinfu.allocate"):
            self.volume = ht.allocate(self.volume, depth, self.intr, T_cw, depth_max=p.depth_max)
        with record_function("kinfu.integrate"):
            self.volume = ht.integrate(self.volume, depth, self.intr, T_cw, max_weight=p.tsdf_max_weight,
                                       depth_max=p.depth_max, gate=gate)
        with record_function("kinfu.raycast"):
            pts, nrm, valid = ht.raycast(self.volume, self.intr, T_cw, shape=p.frame_shape, depth_max=p.depth_max)
            return _pyr_from(pts, nrm, valid, p.pyramid_levels)

    def _first(self, depth):
        """Frame 0: fuse at the first pose; the model is its raycast."""
        self.model_pyr = self._fuse(depth, self.T_cw)

    def _tick(self, depth) -> torch.Tensor:
        """Track the filtered pyramid against the model, fuse the raw depth
        where tracking held, raycast the new model. Returns the flag."""
        p = self.p
        with record_function("kinfu.make_frame"):
            pyr = frame_mod.make_frame(depth, self.intr, levels=p.pyramid_levels)
        with record_function("kinfu.icp"):
            T_rel, ok, _ = icp_mod.estimate_transform(pyr, self.model_pyr, self.intr,
                                                      iterations=p.icp_iterations, dist_thresh=p.icp_dist_thresh)
            T_cw = torch.where(ok, se3.inverse(T_rel) @ self.T_cw, self.T_cw)
        model = self._fuse(depth, T_cw, gate=ok)
        self.model_pyr = tuple(DepthFrame(*(torch.where(ok, a, b) for a, b in zip(new, old)))
                               for new, old in zip(model, self.model_pyr))
        self.T_cw = T_cw
        return ok

    @f32_matmuls
    def update(self, depth, sync: bool = True) -> bool:
        """One frame tick. Returns False on tracking failure; with
        sync=False the flag stays on the device in `last_ok` and nothing is
        read back."""
        with record_function("kinfu.make_frame"):
            depth = to_device(depth, self.device)
        if self.frame_count == 0:
            self._first(depth)
            self.frame_count = 1
            self.last_ok = torch.ones((), dtype=torch.bool, device=self.device)
            return True
        self.last_ok = self._tick(depth)
        self.frame_count += 1
        return bool(self.last_ok) if sync else True

    def n_active_blocks(self) -> int:
        return ht.n_active(self.volume)
