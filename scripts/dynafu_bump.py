#!/usr/bin/env python3
"""DynaFu's growing-bump gate by frame size, volume size, node count and
frame count, in the PyTorch port (opencv_contrib_tpu_torch) or in the JAX
package.

    python3 scripts/dynafu_bump.py --backend torch --scale 8 --res 64 128 256 --nodes 64
    python3 scripts/dynafu_bump.py --backend jax --scale 1 --res 64 128 256 --nodes 32 --frames 5 9
    python3 scripts/dynafu_bump.py --backend torch --device cpu --scale 1 --res 64

The scene is tests/test_rgbd_extras.py:154-185's: a plane at z = 1.5 m with a
Gaussian bump of height 0.2 t (sigma 8 px at 60x80) for t in
linspace(0, 1, frames), seen with intrinsics (70, 70, 40, 30); --scale k
renders it at (60 k) x (80 k) with the intrinsics and the bump's centre and
width times k, the same scene in metres. DynaFu takes a 2 m volume centred at
(0, 0, 1.2), node_sigma 0.3. For each volume size (res^3), node count and
frame count it prints one JSON line: the update flags, the gate's value (the
rim's depth minus the centre's in the live render; the test holds it above
0.05 m), the TSDF truncation (5 voxels) against the bump's growth a frame,
and the seconds the run took.

--backend torch runs the port, on the GPU unless --device cpu; --backend jax
runs the JAX package on the CPU. Each backend imports only its own package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VOLUME = dict(volume_size=2.0, volume_center=(0.0, 0.0, 1.2), node_sigma=0.3)


def frames(scale: int, n: int) -> list:
    H, W = 60 * scale, 80 * scale
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = []
    for t in np.linspace(0.0, 1.0, n):
        bump = 0.2 * t * np.exp(-((yy - 30 * scale) ** 2 + (xx - 40 * scale) ** 2) / (2 * (8.0 * scale) ** 2))
        out.append((1.5 - bump).astype(np.float32))
    return out


def gate(warped: np.ndarray, valid: np.ndarray, scale: int) -> float:
    c = slice(26 * scale, 34 * scale), slice(36 * scale, 44 * scale)
    r = slice(5 * scale, 15 * scale), slice(5 * scale, 15 * scale)
    return float(warped[r][..., 2][valid[r]].mean() - warped[c][..., 2][valid[c]].mean())


def run(backend: str, device: str, scale: int, res: int, nodes: int, n_frames: int) -> dict:
    intr = np.array([70.0 * scale, 70.0 * scale, 40.0 * scale, 30.0 * scale], np.float32)
    kw = dict(VOLUME, frame_shape=(60 * scale, 80 * scale), n_nodes=nodes, volume_resolution=(res,) * 3)
    t0 = time.perf_counter()
    if backend == "torch":
        from opencv_contrib_tpu_torch.rgbd.dynafu import DynaFu

        df = DynaFu(intr, device=device, **kw)
        oks = [df.update(d) for d in frames(scale, n_frames)]
        w, v = (x.cpu().numpy() for x in df.render_live())
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        from opencv_contrib_tpu.rgbd.dynafu import DynaFu

        df = DynaFu(intr, **kw)
        oks = [df.update(jnp.asarray(d)) for d in frames(scale, n_frames)]
        w, v = (np.asarray(x) for x in df.render_live())
    return {"backend": backend, "shape": [60 * scale, 80 * scale], "res": res, "nodes": nodes, "frames": n_frames,
            "ok": oks, "bump_m": gate(w, v, scale), "trunc_m": 5 * VOLUME["volume_size"] / res,
            "growth_per_frame_m": 0.2 / (n_frames - 1), "s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--res", type=int, nargs="+", default=[64])
    ap.add_argument("--nodes", type=int, nargs="+", default=[32])
    ap.add_argument("--frames", type=int, nargs="+", default=[5])
    a = ap.parse_args()
    for res in a.res:
        for nodes in a.nodes:
            for n in a.frames:
                print(json.dumps(run(a.backend, a.device, a.scale, res, nodes, n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
