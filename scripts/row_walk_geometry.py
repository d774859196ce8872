#!/usr/bin/env python3
"""Time geometry variants of the row walk of grid_transform and grid_reduce
(opencv_contrib_tpu_torch/ops/cuda/csrc/maps.cuh: ROW_WALK_TX threads a
block, ROW_WALK_MAP_U / ROW_WALK_REDUCE_U float4s a thread and step on the
vec4 path of a map / a reduction) side by side on one CUDA GPU.

    python3 scripts/row_walk_geometry.py

Each variant is the checkout's csrc/ built by `_build.build()` with its
geometry as -D flags, into a directory of its own under a new temporary
directory (removed at the end), and timed at 1080 x 1920 with chip_smoke's
profiler timing (device ms per call): the `mul` map beside `a * b`, the
identity sum beside `torch.sum` (both also with the L2 flushed before each
call), gray from three channel views, the SSIM map and the AGGD group.
Prints one JSON line per variant, then the card's name and power limit.
Compare variants only inside one run.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

# name -> (ROW_WALK_TX, ROW_WALK_MAP_U, ROW_WALK_REDUCE_U); the first is the
# geometry maps.cuh builds by default
VARIANTS = {"map_u1_reduce_u4": (128, 1, 4), "u4": (128, 4, 4), "u2": (128, 2, 2), "u1": (128, 1, 1),
            "tx256_map_u1_reduce_u4": (256, 1, 4)}


def main() -> int:
    import torch

    from opencv_contrib_tpu_torch.ops.cuda import _build
    from opencv_contrib_tpu_torch.ops.cuda import reduce as kr
    from opencv_contrib_tpu_torch.ops.cuda import transform as tf

    if not torch.cuda.is_available():
        print("row_walk_geometry: no CUDA device", file=sys.stderr)
        return 2
    smoke = chip_smoke.Smoke()
    g = np.random.default_rng(0)
    a, b = (smoke.card(g.standard_normal((1080, 1920))) for _ in range(2))
    u = [smoke.card(g.uniform(0, 1, size=(1080, 1920))) for _ in range(2)]
    ch = [c for c in smoke.card(g.uniform(0, 1, size=(1080, 1920, 3))).unbind(-1)]
    ssim_in = [u[0], u[1], u[0] * u[0] + 0.02, u[1] * u[1] + 0.02, u[0] * u[1]]
    n = float(a.numel())
    calls = {"lib_mul": lambda: a * b, "mul": lambda: tf.grid_transform(tf.mul(), a, b),
             "lib_sum": lambda: torch.sum(u[0]), "sum": lambda: kr.grid_reduce(tf.ident(), u[0]),
             "gray": lambda: tf.grid_transform(tf.gray(), *ch),
             "ssim": lambda: tf.grid_transform(tf.ssim(1e-4, 9e-4), *ssim_in),
             "aggd6": lambda: kr.grid_reduce_sums(tf.aggd_moments(), a, div=(1, 1, 1, 1, n, n))}
    flags, build_root = _build.NVCC_FLAGS, _build.BUILD_ROOT
    root = Path(tempfile.mkdtemp(prefix="row_walk_"))
    try:
        for name, (tx, map_u, reduce_u) in VARIANTS.items():
            _build.NVCC_FLAGS = (*flags, f"-DROW_WALK_TX={tx}", f"-DROW_WALK_MAP_U={map_u}",
                                 f"-DROW_WALK_REDUCE_U={reduce_u}")
            _build.BUILD_ROOT = root / name
            _build._libs.clear()
            t0 = time.perf_counter()
            _build.build()
            row = {"variant": name, "tx": tx, "map_u": map_u, "reduce_u": reduce_u,
                   "build_s": time.perf_counter() - t0}
            chip_smoke.check(bool((tf.grid_transform(tf.mul(), a, b) == a * b).all()), f"{name}: mul differs")
            for label, fn in calls.items():
                row[label + "_ms"] = smoke.device_ms(fn, iters=30)
                if label in ("lib_mul", "mul", "lib_sum", "sum"):
                    row[label + "_cold_ms"] = smoke.device_ms(fn, iters=30, cold=True)
            print(json.dumps(row), flush=True)
    finally:
        _build.NVCC_FLAGS, _build.BUILD_ROOT = flags, build_root
        _build._libs.clear()
        shutil.rmtree(root, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
