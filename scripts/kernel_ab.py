#!/usr/bin/env python3
"""Time two checkouts' knn2, integral_image, integral(), grid_scan, the ICP
getAb kernel, grid_histogram and pyrdown in one run on one CUDA GPU, in
turns: base, this, this, base.

    python3 scripts/kernel_ab.py --base DIR [--out build/kernel_ab.json]

DIR is the root of another checkout of the repository (for instance a
`git archive` of the parent commit unpacked under build/). Each turn is a
process of its own that imports the port from its checkout (which builds
that checkout's kernels into its own build/kernels/) and times each kernel
at the shapes of this checkout's chip_smoke.py phases b and c, with its
Timer: device time per call from torch.profiler over 30 calls, L2-warm and
L2-cold (a 128 MiB read before each call), and device launches per call.
getAb runs at the three ICP levels of phase g's orbit frames (frames 1
against 0, at phase g's 1 cm / 0.01 rad offset pose); grid_histogram at
CLAHE's 8x8 tiles x 256 bins of a uniform 1080x1920 frame and of the gray of
`entry.photo_clip`'s first clean frame (smooth: a tile's values fall into a
few bins), and on the uniform frame in both rules; pyrdown in the reflect
border at the Sintel pyramid's levels 0-2 (436x1024, 218x512, 109x256).
Each turn also times the launch floor: `add_(1)` on a one-element tensor,
the smallest launch PyTorch makes; and, on the host's clock, the blurs of
the photometric path (`filters.gaussian_blur` at sigma 1.5, SSIM's 11
taps, on a 1080x1920 frame; `filters.conv2d` with a 3x3 kernel and the
reflect border, GMSD's, on 540x960: ms per call over 20 calls, synchronised
at the end, the median of 7) and a photometric frame (`entry.photometric`
on `entry.photo_clip()`'s 8-frame clip: ms per frame of a synchronised
clip, the median of 5 warm runs), where host code such as the reflect pad
shows; and the keyframe tick's bundle adjustment (`bundle.bundle_adjust` of
`entry.ba_problem(16, 2048)`, 10 LM iterations): device ms, launches and
host ms a call. Inputs are made from one seed, so both checkouts see the
same data.
It prints one JSON line per turn, the card's name and power limit, and
writes every turn to --out.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import opencv_contrib_tpu_torch as port
    from opencv_contrib_tpu_torch import entry
    from opencv_contrib_tpu_torch.ba import bundle
    from opencv_contrib_tpu_torch.core import se3
    from opencv_contrib_tpu_torch.ops import filters, integral
    from opencv_contrib_tpu_torch.ops.cuda import _build, histogram, matching, pyramid, reduce, scan
    from opencv_contrib_tpu_torch.rgbd import frame
    from opencv_contrib_tpu_torch.utils import sdf_scene

    assert Path(port.__file__).resolve().is_relative_to(root.resolve()), port.__file__
    spec = importlib.util.spec_from_file_location("chip_smoke_timer", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    timer = smoke.Timer(torch, dev)
    _build.build()
    gen = np.random.default_rng(0)
    card = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)  # noqa: E731

    def row(name, shape, fn):
        return {"kernel": name, "shape": list(shape), "ms": timer.device_ms(fn, iters=30),
                "cold_ms": timer.device_ms(fn, iters=30, cold=True), "launches_per_call": timer.launches_per_call(fn)}

    rows = []
    for Q, T, D in smoke.KNN2_SHAPES:
        q, t = card(gen.normal(size=(Q, D))), card(gen.normal(size=(T, D)))
        rows.append(row("knn2", (Q, T, D), lambda: matching.knn2(q, t)))
    for H, W in smoke.SCAN_SHAPES:
        x = card(gen.uniform(0, 255, size=(H, W)))
        rows.append(row("integral_image", (H, W), lambda: scan.integral_image(x)))
        rows.append(row("integral", (H, W), lambda: integral.integral(x)))
    for H, W in smoke.GRID_SCAN_SHAPES:
        x = card(gen.uniform(0, 255, size=(H, W)))
        rows.append(row("grid_scan", (H, W), lambda: scan.grid_scan(x)))
    poses = sdf_scene.orbit_poses(smoke.N_ORBIT, sweep=smoke.ORBIT_SWEEP)
    intr = card(smoke.KINFU_INTR)
    dst, src = (frame.make_frame(sdf_scene.render_depth(card(p), intr, shape=(480, 640)), intr) for p in poses[:2])
    T = se3.exp_se3(card(smoke.ICP_OFFSET))
    for lvl in range(3):
        s, d = src[lvl], dst[lvl]
        args = (T, s.points, s.normals, s.valid, d.points, d.normals, d.valid, frame.level_intrinsics(intr, lvl),
                0.1 * (1 << lvl))
        rows.append(row("icp_getab", s.valid.shape, lambda: reduce.icp_getab(*args)))
    H, W = smoke.PHOTO_CLIP[1:]
    uniform = torch.clamp(card(gen.uniform(0, 1, size=(H, W))) * 1.1 - 0.05, -1.0, 2.0)
    clean = entry.photo_clip(1, H, W, seed=0)[0][0]
    smooth = card(clean @ np.asarray([0.299, 0.587, 0.114], np.float32))
    for label, x, rule, tiles in (("clahe_tiles uniform", uniform, "clamp", (8, 8)),
                                  ("clahe_tiles smooth", smooth, "clamp", (8, 8)),
                                  ("frame_clamp uniform", uniform, "clamp", None),
                                  ("frame_drop uniform", uniform, "drop", None)):
        rows.append({**row("grid_histogram", (H, W), lambda: histogram.grid_histogram(x, 256, 0.0, 1.0, rule, tiles)),
                     "case": label})
    for H, W in smoke.PYRDOWN_SHAPES[:3]:
        x = card(gen.uniform(0, 4, size=(H, W)))
        rows.append(row("pyrdown", (H, W), lambda: pyramid.pyrdown(x)))

    def wall_ms(fn, calls, repeats):
        """Host ms per call of `calls` calls synchronised at the end: the
        median of `repeats`, after one warm call."""
        fn()
        ms = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / calls)
        return float(np.median(ms)), ms

    n_frames, H, W = smoke.PHOTO_CLIP
    frame = card(gen.uniform(0, 1, size=(H, W)))
    half = card(gen.uniform(0, 1, size=(H // 2, W // 2)))
    k3 = card(np.array([[1, 0, -1]] * 3, np.float32) / 3)
    clean, degraded = entry.photo_clip(n_frames, H, W, seed=0)
    cln, deg = card(clean), card(degraded)
    del clean, degraded
    entry.photometric(deg[:1], cln[:1])  # warm-up: cuDNN, the BRISQUE tables, allocator
    host = {}
    for label, fn, calls, repeats in (
            ("gaussian_blur 1080x1920 sigma 1.5", lambda: filters.gaussian_blur(frame, 1.5), 20, 7),
            ("conv2d reflect 540x960 3x3", lambda: filters.conv2d(half, k3), 20, 7),
            ("photometric clip", lambda: entry.photometric(deg, cln), 1, 5)):
        med, ms = wall_ms(fn, calls, repeats)
        host[label] = {"ms_median": med, "ms": ms}
    host["photometric frame ms_median"] = host["photometric clip"]["ms_median"] / n_frames
    prob = entry.ba_problem(16, 2048, device=dev)

    def ba():
        return bundle.bundle_adjust(prob, n_iters=10)

    med, ms = wall_ms(ba, 1, 7)
    host["bundle_adjust 16x2048 10 iterations"] = {"ms_median": med, "ms": ms}
    rows.append({"kernel": "bundle_adjust (10 LM iterations)", "shape": [16, 2048],
                 "ms": timer.device_ms(ba, iters=3), "launches_per_call": timer.launches_per_call(ba, iters=3)})
    return {"root": str(root), "device": torch.cuda.get_device_name(0), "launch_floor_ms": timer.launch_floor_ms(),
            "rows": rows, "host_wall": host}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, help="root of the checkout to compare with")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_ab.json")
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    import torch

    if args.base is None:
        ap.error("--base is required")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    turns = []
    for label, root in (("base", args.base), ("this", ROOT), ("this", ROOT), ("base", args.base)):
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(root.resolve())],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stdout, p.stderr, file=sys.stderr)
            return p.returncode
        turn = {"label": label, **json.loads(p.stdout.strip().splitlines()[-1])}
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
