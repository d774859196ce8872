#!/usr/bin/env python3
"""Blocks that `hash_tsdf.allocate` takes for one depth frame, by the frame
the block grid is laid in, in the PyTorch port (opencv_contrib_tpu_torch).

    python3 scripts/hash_allocate_blocks.py            # the CPU, and the GPU when there is one
    python3 scripts/hash_allocate_blocks.py --devices cpu

The frame is frame 0 of chip_smoke.py phase p's orbit (`orbit_poses(8,
sweep=0.5)`, 640 x 480, intrinsics 400/400/320/240; also 160 x 120 with the
intrinsics scaled), rendered by the port's scene on the CPU, with 3 m / 512
voxels and a 16,384-block pool. Two poses of the grid: the scene's own
frame (T_cw = the orbit pose's inverse), where the cube's faces and the
floor lie along the grid's axes, and KinFu's world, the first camera's
frame (T_cw = I), where they lie oblique to it. For each shape, pose and
device it prints one JSON line: the active blocks, whether the active keys
are distinct and sorted, and whether the keys equal those of the first
device listed (the CPU by default).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from opencv_contrib_tpu_torch.core import se3  # noqa: E402
from opencv_contrib_tpu_torch.rgbd import hash_tsdf  # noqa: E402
from opencv_contrib_tpu_torch.utils import sdf_scene  # noqa: E402

INTR = np.array([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0, 0], np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", nargs="+", default=["cpu"] + (["cuda"] if torch.cuda.is_available() else []))
    args = ap.parse_args()
    pose = torch.from_numpy(sdf_scene.orbit_poses(8, sweep=0.5)[0])
    for H, W in ((120, 160), (480, 640)):
        intr = torch.from_numpy(INTR * np.array([W / 640] * 4 + [1] * 5, np.float32))
        depth = sdf_scene.render_depth(pose, intr, shape=(H, W))
        for grid, T_cw in (("scene", se3.inverse(pose)), ("first_camera", torch.eye(4))):
            first_keys = None
            for dev in args.devices:
                vol = hash_tsdf.allocate(hash_tsdf.create(16384, 3.0 / 512, device=dev), depth.to(dev),
                                         intr.to(dev), T_cw.to(dev))
                keys, active = vol.keys.cpu().numpy(), vol.active.cpu().numpy()
                first_keys = keys if first_keys is None else first_keys
                print(json.dumps({"shape": [H, W], "grid": grid, "device": dev, "active": int(active.sum()),
                                  "distinct": len(np.unique(keys[active])) == int(active.sum()),
                                  "sorted": bool((np.diff(keys.astype(np.int64)) >= 0).all()),
                                  "keys_equal_first_device": bool((keys == first_keys).all())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
