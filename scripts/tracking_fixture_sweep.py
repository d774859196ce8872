#!/usr/bin/env python3
"""How often MOSSE and the scale-adaptive CSRT meet their JAX tests' gates
across backgrounds and textures (the port on the CPU; the JAX package gives
the same centres on these fixtures, tests/test_torch_tracking.py).

    python3 scripts/tracking_fixture_sweep.py [--seeds 10]

- MOSSE: tests/test_tracking.py::_target_sequence's recipe (a blurred
  U(0, 0.3) background, a blurred U(0.5, 1) 21 x 21 texture at (2, 3) px a
  frame) with numpy seed s, at the test's 128 x 128 over its 11 updates
  and at 480 x 640 over 29: the largest centre error (gate 2.5 px).
- The scaled CSRT: TestDsstScale's zoom (a U(0.2, 1) 64 x 64 texture from
  seed s, resized linearly from 24 to 48 px over 20 frames): the IoU of
  the last box (gate 0.7).
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from opencv_contrib_tpu_torch import entry  # noqa: E402
from opencv_contrib_tpu_torch.ops import filters  # noqa: E402
from opencv_contrib_tpu_torch.tracking import correlation, dsst  # noqa: E402


def _sequence(n, shape, start, vel, seed):
    rng = np.random.default_rng(seed)
    bg = filters.gaussian_blur(torch.from_numpy(rng.uniform(0, 0.3, shape).astype(np.float32)), 2.0).numpy()
    tex = filters.gaussian_blur(torch.from_numpy(rng.uniform(0.5, 1.0, (21, 21)).astype(np.float32)), 1.0).numpy()
    frames, centers = [], []
    for i in range(n):
        cy, cx = start[0] + vel[0] * i, start[1] + vel[1] * i
        f = bg.copy()
        iy, ix = int(round(cy)) - 10, int(round(cx)) - 10
        f[iy:iy + 21, ix:ix + 21] = tex
        frames.append(torch.from_numpy(f))
        centers.append((cy, cx))
    return frames, centers


def mosse_err(n, shape, start, seed) -> float:
    frames, centers = _sequence(n, shape, start, (2.0, 3.0), seed)
    st = correlation.mosse_init(frames[0], centers[0])
    worst = 0.0
    for f, c in zip(frames[1:], centers[1:]):
        st, _ = correlation.mosse_update(st, f)
        worst = max(worst, float(np.linalg.norm(st.center.numpy() - c)))
    return worst


def csrt_scale_iou(seed, H=160, W=160) -> float:
    frames, sizes = entry._zoom_frames(np.random.default_rng(seed), H, W, 24, 48)
    st = dsst.csrt_scale_init(torch.from_numpy(frames[0]), (H / 2.0, W / 2.0), target_hw=(int(sizes[0]),) * 2)
    for f in frames[1:]:
        st, (_, box), _ = dsst.csrt_scale_update(st, torch.from_numpy(f))
    est, true = float(box[0]), float(sizes[-1])
    inter = min(est, true) ** 2
    return inter / (est * est + true * true - inter)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    seeds = range(ap.parse_args().seeds)
    m128 = [mosse_err(12, (128, 128), (40.0, 40.0), s) for s in seeds]
    mvga = [mosse_err(30, (480, 640), (100.0, 100.0), s) for s in seeds]
    iou = [csrt_scale_iou(s) for s in seeds]
    print(json.dumps({"mosse_err_px_128": m128, "mosse_pass_128": sum(e < 2.5 for e in m128),
                      "mosse_err_px_vga_29": mvga, "mosse_pass_vga_29": sum(e < 2.5 for e in mvga),
                      "csrt_scale_iou": iou, "csrt_scale_pass": sum(v > 0.7 for v in iou), "seeds": len(seeds),
                      "device": "cpu"}))


if __name__ == "__main__":
    main()
