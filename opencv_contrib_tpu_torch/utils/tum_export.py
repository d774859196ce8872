"""TUM RGB-D sequence writer (the on-disk format of fr1/desk etc.) — the
port of opencv_contrib_tpu/utils/tum_export.py. PNGs are written by the
port's own codec (`utils/png.py`) and the quaternions come from its
`core.se3.mat_to_quat` (float32 on the CPU).

Lets the synthetic SDF scenes produce a REAL TUM-layout dataset —
rgb/ + depth/ 16-bit PNGs, rgb.txt / depth.txt indices, groundtruth.txt
quaternion trajectory — so the full data path (reader -> native loader ->
KinFu -> ATE) can be driven end-to-end without the real download
(reference gates: rgbd/test/test_kinfu.cpp:326-330; format:
datasets/src/slam_*.cpp and the TUM benchmark tools).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.utils import png
from opencv_contrib_tpu_torch.utils.io import _np


def write_tum_sequence(root: str, depths_m, poses_c2w, rgbs=None,
                       fps: float = 30.0, depth_scale: float = 5000.0):
    """Write a TUM-layout sequence.

    depths_m: list of (H, W) float32 depth maps in meters (0 = invalid).
    poses_c2w: list of (4, 4) camera->world poses (groundtruth.txt rows).
    rgbs: optional list of (H, W[, 3]) float images; synthesized if None.
    Arrays or tensors on any device.
    """
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_rows, depth_rows, gt_rows = [], [], []
    for i, d in enumerate(depths_m):
        t = i / fps
        ts = f"{t:.6f}"
        d = _np(d)
        d16 = np.clip(np.asarray(d, np.float64) * depth_scale,
                      0, 65535).astype(np.uint16)
        png.write(os.path.join(root, "depth", f"{ts}.png"), d16)
        depth_rows.append(f"{ts} depth/{ts}.png")
        if rgbs is not None:
            rgb = _np(rgbs[i])
        else:
            # shaded depth as a stand-in rgb stream
            rgb = np.clip(np.asarray(d) / 4.0, 0, 1)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, axis=-1)
        png.write(os.path.join(root, "rgb", f"{ts}.png"), (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        rgb_rows.append(f"{ts} rgb/{ts}.png")

        T = np.asarray(_np(poses_c2w[i]), np.float64)
        q = se3.mat_to_quat(torch.from_numpy(T[:3, :3].astype(np.float32))).numpy()
        w, x, y, z = (float(v) for v in q)
        tx, ty, tz = T[:3, 3]
        gt_rows.append(f"{ts} {tx:.6f} {ty:.6f} {tz:.6f} "
                       f"{x:.6f} {y:.6f} {z:.6f} {w:.6f}")

    for name, rows, hdr in (("rgb.txt", rgb_rows, "color images"),
                            ("depth.txt", depth_rows, "depth maps"),
                            ("groundtruth.txt", gt_rows, "ground truth")):
        with open(os.path.join(root, name), "w") as f:
            f.write(f"# {hdr}\n# timestamp data\n")
            f.write("\n".join(rows) + "\n")
