"""Dataset readers — the port of opencv_contrib_tpu/utils/datasets.py.

Parity: the datasets module's SLAM/MVS loader classes —
SLAM_kitti (datasets/src/slam_kitti.cpp), SLAM_tumindoor
(slam_tumindoor.cpp), MSM_epfl/middlebury readers — plus TUM RGB-D
association and MPI-Sintel flow IO (the optflow benchmark format).

All readers are host-side index builders returning numpy arrays / file
lists; pixel data flows to device in batches. Only `tum_gt_pose_at` computes
with the port (`core.se3.quat_to_mat`, float32 on the CPU).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from opencv_contrib_tpu_torch.core import se3


# ----------------------------------------------------------------------------
# TUM RGB-D (the BASELINE ATE config)
# ----------------------------------------------------------------------------


@dataclass
class TumSequence:
    root: str
    rgb: list  # (timestamp, path)
    depth: list
    gt: np.ndarray | None  # (N, 8): t, tx ty tz, qx qy qz qw
    pairs: list  # associated (t_rgb, rgb_path, t_depth, depth_path)


def _read_tum_list(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), *parts[1:]))
    return out


def associate(a, b, max_dt: float = 0.02):
    """Greedy timestamp association (the TUM associate.py contract)."""
    pairs = []
    used = set()
    for ta, *ra in a:
        best, bestdt = None, max_dt
        for j in range(len(b)):
            if j in used:
                continue
            dt = abs(b[j][0] - ta)
            if dt < bestdt:
                best, bestdt = j, dt
        if best is not None:
            used.add(best)
            pairs.append((ta, *ra, b[best][0], *b[best][1:]))
    return pairs


def load_tum(root: str) -> TumSequence:
    rgb = _read_tum_list(os.path.join(root, "rgb.txt"))
    depth = _read_tum_list(os.path.join(root, "depth.txt"))
    gt = None
    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        rows = _read_tum_list(gt_path)
        gt = np.array([[r[0]] + [float(x) for x in r[1:]] for r in rows], np.float64)
    pairs = associate(rgb, depth)
    return TumSequence(root=root, rgb=rgb, depth=depth, gt=gt, pairs=pairs)


TUM_FR1_INTR = np.array([517.3, 516.5, 318.6, 255.3, 0, 0, 0, 0, 0], np.float32)
TUM_DEFAULT_INTR = np.array([525.0, 525.0, 319.5, 239.5, 0, 0, 0, 0, 0], np.float32)


def tum_gt_pose_at(gt: np.ndarray, t: float) -> np.ndarray:
    """Nearest ground-truth pose as a 4x4 cam->world matrix."""
    i = int(np.argmin(np.abs(gt[:, 0] - t)))
    tx, ty, tz, qx, qy, qz, qw = gt[i, 1:8]
    R = se3.quat_to_mat(torch.tensor([qw, qx, qy, qz], dtype=torch.float32)).numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = [tx, ty, tz]
    return T


# ----------------------------------------------------------------------------
# KITTI odometry (SLAM_kitti parity)
# ----------------------------------------------------------------------------


@dataclass
class KittiSequence:
    root: str
    image_paths: list
    calib: dict
    poses: np.ndarray | None  # (N, 3, 4)


def load_kitti_odometry(seq_dir: str, poses_file: str | None = None, camera: str = "image_0") -> KittiSequence:
    img_dir = os.path.join(seq_dir, camera)
    imgs = sorted(
        os.path.join(img_dir, f) for f in os.listdir(img_dir) if f.endswith((".png", ".jpg"))
    ) if os.path.isdir(img_dir) else []
    calib = {}
    calib_path = os.path.join(seq_dir, "calib.txt")
    if os.path.exists(calib_path):
        with open(calib_path) as f:
            for line in f:
                if ":" in line:
                    k, v = line.split(":", 1)
                    calib[k.strip()] = np.array([float(x) for x in v.split()], np.float64).reshape(3, 4)
    poses = None
    if poses_file and os.path.exists(poses_file):
        rows = np.loadtxt(poses_file)
        poses = rows.reshape(-1, 3, 4)
    return KittiSequence(root=seq_dir, image_paths=imgs, calib=calib, poses=poses)


# ----------------------------------------------------------------------------
# MPI-Sintel flow IO (the EPE benchmark format)
# ----------------------------------------------------------------------------

_SINTEL_TAG = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury/Sintel .flo -> (H, W, 2) as (dx, dy)."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        assert abs(tag - _SINTEL_TAG) < 1e-3, "bad .flo magic"
        W = int(np.frombuffer(f.read(4), np.int32)[0])
        H = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(H * W * 2 * 4), np.float32)
    return data.reshape(H, W, 2)


def write_flo(path: str, flow_xy: np.ndarray):
    H, W = flow_xy.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(_SINTEL_TAG).tobytes())
        f.write(np.int32(W).tobytes())
        f.write(np.int32(H).tobytes())
        f.write(flow_xy.astype(np.float32).tobytes())


def flow_yx_to_xy(flow_yx: np.ndarray) -> np.ndarray:
    """Our (dy, dx) convention -> Sintel's (dx, dy)."""
    return flow_yx[..., ::-1]
