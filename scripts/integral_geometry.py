#!/usr/bin/env python3
"""Time the integral kernel (opencv_contrib_tpu_torch/ops/cuda/csrc/scan.cu)
at other slab geometries than `scan.slabs` picks, side by side on one CUDA
GPU.

    python3 scripts/integral_geometry.py [--out build/integral_geometry.json]

For each shape: the plans `scan.slabs` makes with 40, 32, 48 and 56 bands
(its `_BANDS`; the repo's is 48), and a few fixed geometries (R rows by Cw
columns a slab), each launched through the C entry point with its own
scratch, held to the plain table (2e-6 of its largest entry, as chip_smoke
phase c) and timed with chip_smoke's profiler timing (device ms per call,
30 calls, L2-warm) in three turns. Prints one JSON line per shape, then the
card's name and power limit. Compare geometries only inside one run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (H, W) -> fixed (R, Cw) geometries tried beside the band-count plans
SHAPES = {(480, 640): [(10, 640), (16, 640), (12, 320)],
          (2048, 2048): [(32, 1024), (64, 512), (40, 684)],
          (4000, 8000): [(64, 500), (50, 472), (100, 256)]}
BANDS = (40, 32, 48, 56)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "integral_geometry.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("integral_geometry: no CUDA device", file=sys.stderr)
        return 2
    from opencv_contrib_tpu_torch.ops.cuda import _build, scan

    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(torch, dev)
    lib = _build.lib("scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = np.random.default_rng(0)
    runs = []
    for (H, W), fixed in SHAPES.items():
        x = torch.from_numpy(gen.uniform(0, 255, (H, W)).astype(np.float32)).to(dev)
        ref = scan.integral_image_plain(x)
        geoms = {}
        for n in BANDS:
            with mock.patch.object(scan, "_BANDS", n):
                geoms[f"bands_{n}"] = scan.slabs(H, W)
        geoms.update({f"{R}x{Cw}": (R, Cw) for R, Cw in fixed})
        calls = {}
        for name, (R, Cw) in geoms.items():
            n = -(-H // R) * -(-W // Cw)
            sc = scan._Scratch(dev, 1 + 2 * n, n * Cw, n * R)
            y = torch.empty_like(x)

            def call(R=R, Cw=Cw, n=n, sc=sc, y=y):
                base, epoch = sc.next(n)
                _build.check(lib.integral_f32(x.data_ptr(), y.data_ptr(), H, W, W, 0, R, Cw, sc.ctrl.data_ptr(), base,
                                              epoch, sc.tot.data_ptr(), sc.rtot.data_ptr(), stream), "integral_f32")
                return y

            err = float((call() - ref).abs().max())
            chip_smoke.check(err <= 2e-6 * float(ref.abs().max()), f"{H}x{W} {name}: max err {err}")
            calls[name] = call
        us = {name: [] for name in calls}
        for turn in range(3):
            for name in (list(calls) if turn % 2 == 0 else list(reversed(calls))):
                us[name].append(timer.device_ms(calls[name], iters=30) * 1e3)
        run = {"shape": [H, W], "geometry": {k: list(v) for k, v in geoms.items()}, "us": us}
        runs.append(run)
        print(json.dumps(run), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
