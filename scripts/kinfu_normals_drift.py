#!/usr/bin/env python3
"""KinectFusion orbit drift by model-normal source and volume size, in the
PyTorch port (opencv_contrib_tpu_torch) or in the JAX package.

    python3 scripts/kinfu_normals_drift.py --backend torch --res 264 384 512
    python3 scripts/kinfu_normals_drift.py --backend jax --res 264 --depths orbit.npy
    python3 scripts/kinfu_normals_drift.py --backend torch --device cpu --res 264 --depths orbit.npy

The orbit is the accuracy cell of chip_smoke.py phase h: tests/test_rgbd.py's
cube-and-spheres scene, 8 frames of `orbit_poses(8, sweep=0.5)` rendered at
480 x 640 with intrinsics 525/525/320/240, a 3.2 m volume centred at
(0, 0, 2.2) and 12288 sparse blocks. Above 256^3 voxels KinFu's model
raycast is the splatting one; the JAX package takes screen-space normals
there and the port the TSDF gradient. For each volume size and each normal
source this runs the orbit through `KinFu.update` and prints one JSON line:
the last frame's drift against the true orbit (rotation in rad, translation
in m; the reference gate is 0.02 / 0.1), the per-frame tracking flags and
the seconds the orbit took.

--backend torch runs the port, on the GPU unless --device cpu; --backend jax
runs the JAX package on the CPU. Each backend imports only its own package.
--depths PATH reads the depth frames from PATH (.npy) when it exists, and
otherwise renders them with the backend's own scene and writes them there,
so that both packages can track the same frames.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

INTR = [525.0, 525.0, 320.0, 240.0, 0, 0, 0, 0, 0]
SHAPE = (480, 640)
N_FRAMES, SWEEP = 8, 0.5
VOLUME = dict(frame_shape=SHAPE, volume_size=3.2, volume_center=(0.0, 0.0, 2.2), sparse_blocks=12288)


def torch_backend(device: str):
    """(poses, render, track, log) for the port."""
    import torch

    from opencv_contrib_tpu_torch.core import se3
    from opencv_contrib_tpu_torch.rgbd import kinfu, tsdf
    from opencv_contrib_tpu_torch.utils import sdf_scene

    poses = sdf_scene.orbit_poses(N_FRAMES, sweep=SWEEP)

    def render():
        it = torch.tensor(INTR, dtype=torch.float32, device=device)
        return np.stack([sdf_scene.render_depth(torch.from_numpy(p).to(device), it, shape=SHAPE).cpu().numpy()
                         for p in poses])

    def track(depths, res, normals):
        p = kinfu.KinFuParams(intr=np.asarray(INTR, np.float32), volume_resolution=(res,) * 3, **VOLUME)
        splat = tsdf.raycast_splat
        with mock.patch.object(tsdf, "raycast_splat", lambda *a, **k: splat(*a, **{**k, "normals": normals})):
            kf = kinfu.KinFu(p, device=device)
            ok = [kf.update(d) for d in depths]
        return kf.pose, ok

    def log(T):
        return se3.log_se3(torch.from_numpy(np.asarray(T, np.float32))).numpy()

    return poses, render, track, log


def jax_backend():
    """(poses, render, track, log) for the JAX package, on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from opencv_contrib_tpu.core import se3
    from opencv_contrib_tpu.rgbd import kinfu, tsdf
    from opencv_contrib_tpu.utils import sdf_scene

    poses = sdf_scene.orbit_poses(N_FRAMES, sweep=SWEEP)

    def render():
        return np.stack([np.asarray(sdf_scene.render_depth(jnp.asarray(p), jnp.asarray(INTR), shape=SHAPE))
                         for p in poses])

    def track(depths, res, normals):
        p = kinfu.KinFuParams(intr=np.asarray(INTR, np.float32), volume_resolution=(res,) * 3, **VOLUME)
        splat = tsdf.raycast_splat
        with mock.patch.object(tsdf, "raycast_splat", lambda *a, **k: splat(*a, **{**k, "normals": normals})):
            kf = kinfu.KinFu(p)
            ok = [bool(kf.update(d)) for d in depths]
        return kf.pose, ok

    def log(T):
        return np.asarray(se3.log_se3(jnp.asarray(T, jnp.float32)))

    return poses, render, track, log


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("torch", "jax"), required=True)
    ap.add_argument("--device", default="cuda", help="the port's device (torch backend)")
    ap.add_argument("--res", type=int, nargs="+", default=[512], help="volume resolutions (multiples of 8)")
    ap.add_argument("--depths", help=".npy of the (8, 480, 640) depth frames: read if present, else written")
    args = ap.parse_args()

    poses, render, track, log = torch_backend(args.device) if args.backend == "torch" else jax_backend()
    if args.depths and os.path.exists(args.depths):
        depths, source = np.load(args.depths), args.depths
    else:
        depths, source = render(), f"{args.backend} sdf_scene"
        if args.depths:
            np.save(args.depths, depths)
    T_gt = np.linalg.inv(poses[0]) @ poses[-1]  # KinFu's world is the first camera's frame
    for res in args.res:
        for normals in ("screen", "gradient"):
            t0 = time.perf_counter()
            pose, ok = track(depths, res, normals)
            s = time.perf_counter() - t0
            d = log(np.linalg.inv(T_gt) @ pose)
            print(json.dumps({"backend": args.backend, "device": args.device if args.backend == "torch" else "cpu",
                              "res": res, "normals": normals, "depths": source,
                              "drift": {"rot": float(np.linalg.norm(d[:3])), "trans": float(np.linalg.norm(d[3:]))},
                              "ok": ok, "s": s}), flush=True)


if __name__ == "__main__":
    main()
