#!/usr/bin/env python3
"""Time the ICP getAb kernel (csrc/reduce_vec.cu) and grid_histogram
(csrc/histogram.cu) at other geometries than their wrappers pick, side by
side on one CUDA GPU.

    python3 scripts/getab_histogram_geometry.py [--out build/getab_histogram_geometry.json]

getAb: at each ICP level of chip_smoke phase g's orbit frames (frame 1
against frame 0 at the 1 cm / 0.01 rad offset pose), the block count of
`reduce.getab_plan` and others, each launched through the C entry point and
held to the plan's n_corr and to its A and b within 1e-4 of their largest
entry. grid_histogram: CLAHE's 8x8 tiles x 256 bins and the frame (clamp
rule) of a uniform 1080x1920 frame, the gray of `entry.photo_clip`'s first
clean frame (smooth) and a constant frame (flat: every value in one bin,
the most contention), at the blocks a tile and the copies of a tile's
counts in the scratch (the spread) of `histogram.plan` and others; then, at
the plan's geometry and in two turns with the checkout's kernel (the clamp
rule's quotient by q = 1 as the product by inv_q = 1), the same kernel with
inv_q = 0 (a correctly rounded division) and the VARIANTS of its source that
`variant_source` writes (8 and 32 copies of the shared bins), built into a
temporary directory under build/ that is removed at the end. Each
call is held to the plain counts. Times are chip_smoke's profiler timing
(device ms per call, 30 calls, L2-warm). Prints one JSON line per case, then the card's
name and power limit. Compare geometries only inside one run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GETAB_BLOCKS = (10, 19, 38, 75, 150, 264)
CLAHE_PER_TILE = (2, 4, 8, 16)
FRAME_BLOCKS = (132, 254, 507, 1013)
VARIANTS = ("copies8", "copies32")


def variant_source(name: str, text: str) -> str:
    """csrc/histogram.cu with the change that makes variant `name`,
    "copiesN": N copies of the shared bins, lane l of a warp counting into
    copy l % N and each bin's copies folded from a rotated start."""
    n = int(name.removeprefix("copies"))
    patches = [("atomicAdd(sh + b, 1)", f"atomicAdd(sh + b * {n} + (threadIdx.x & {n - 1}), 1)"),
               ("k < bins; k += THREADS) sh[k] = 0;", f"k < bins * {n}; k += THREADS) sh[k] = 0;"),
               ("    const int s = sh[b];\n",
                f"    int s = 0;\n    for (int j = 0; j < {n}; ++j) s += sh[b * {n} + ((j + b) & {n - 1})];\n"),
               ("(size_t)r.bins * sizeof(int)", f"(size_t)r.bins * {n} * sizeof(int)"),
               ("(size_t)bins * sizeof(int) > SMEM", f"(size_t)bins * {n} * sizeof(int) > SMEM")]
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: csrc/histogram.cu does not hold {old!r} once")
        text = text.replace(old, new)
    return text


def variant_libs(root: Path, _build) -> dict:
    """The VARIANTS of csrc/histogram.cu, each built by its own nvcc (all
    started together) into root and loaded with the checkout's argtypes."""
    text = (_build.CSRC / "histogram.cu").read_text()
    procs = {}
    for name in VARIANTS:
        src, lib = root / f"histogram_{name}.cu", root / f"libhistogram_{name}.so"
        src.write_text(variant_source(name, text))
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].grid_histogram_f32
        fn.argtypes, fn.restype = _build.SIGNATURES["histogram"]["grid_histogram_f32"], ctypes.c_int
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "getab_histogram_geometry.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("getab_histogram_geometry: no CUDA device", file=sys.stderr)
        return 2
    from opencv_contrib_tpu_torch import entry
    from opencv_contrib_tpu_torch.core import se3
    from opencv_contrib_tpu_torch.ops.cuda import _build
    from opencv_contrib_tpu_torch.ops.cuda import histogram as kh
    from opencv_contrib_tpu_torch.ops.cuda import reduce
    from opencv_contrib_tpu_torch.rgbd import frame

    smoke = chip_smoke.Smoke()
    dev, card = smoke.dev, smoke.card
    stream = torch.cuda.current_stream(dev).cuda_stream
    runs = []

    def emit(row):
        runs.append(row)
        print(json.dumps(row), flush=True)

    # getAb: block counts at the three ICP levels
    _, depths = smoke.orbit_depths()
    intr = card(chip_smoke.KINFU_INTR)
    dst, src = frame.make_frame(depths[0], intr), frame.make_frame(depths[1], intr)
    T = se3.exp_se3(card(chip_smoke.ICP_OFFSET))
    lib = _build.lib("reduce_vec")
    scratch = reduce._scratch_for(dev, stream)
    for lvl in range(3):
        s, d = src[lvl], dst[lvl]
        it = frame.level_intrinsics(intr, lvl)
        H, W = s.valid.shape
        dist = 0.1 * (1 << lvl)
        A, b, n, _ = reduce.icp_getab(T, s.points, s.normals, s.valid, d.points, d.normals, d.valid, it, dist)
        ptrs = [x.contiguous().data_ptr() for x in (T, it, s.points, s.normals, s.valid, d.points, d.normals, d.valid)]
        out = torch.empty(44, device=dev)
        plan = reduce.getab_plan(H, W)
        for blocks in sorted({plan, *GETAB_BLOCKS}):
            def call(blocks=blocks):
                _build.check(lib.icp_getab_f32(*ptrs, H * W, H, W, float(np.float32(dist * dist)), reduce._cos32(0.52),
                                               blocks, scratch.data_ptr(), out.data_ptr(), stream), "icp_getab_f32")
            call()
            torch.cuda.synchronize()
            chip_smoke.check(float(out[42]) == float(n)
                             and float((out[:36].view(6, 6) - A).abs().max()) <= 1e-4 * float(A.abs().max())
                             and float((out[36:42] - b).abs().max()) <= 1e-4 * float(b.abs().max()),
                             f"getAb level {lvl} at {blocks} blocks differs from the plan's")
            emit({"kernel": "icp_getab", "level": lvl, "shape": [H, W], "blocks": blocks, "plan": blocks == plan,
                  "ms": smoke.device_ms(call, iters=30)})

    # grid_histogram: blocks a tile and spreads, then the variants of the
    # kernel, in turns with the checkout's
    Hh, Wh = chip_smoke.PHOTO_CLIP[1:]
    frames = {"uniform": card(np.random.default_rng(0).uniform(0, 1, size=(Hh, Wh))),
              "smooth": card(entry.photo_clip(1, Hh, Wh, seed=0)[0][0] @ np.asarray([0.299, 0.587, 0.114], np.float32)),
              "flat": torch.full((Hh, Wh), 0.37, device=dev)}
    cases = [("clahe_tiles", (8, 8), CLAHE_PER_TILE), ("frame", None, FRAME_BLOCKS)]
    refs = {(name, label): kh.grid_histogram_plain(x, 256, 0.0, 1.0, "clamp", tiles)
            for name, x in frames.items() for label, tiles, _ in cases}

    def sweep(hl, variant, geometries_of, inv_q=1.0):
        for label, tiles, options in cases:
            ty, tx = tiles or (1, 1)
            rows, cols = Hh // ty, Wh // tx
            out = torch.empty((ty * tx, 256), device=dev)
            tickets, counts = kh._scratch_for(dev, stream, ty * tx, kh._MAX_SPREAD * 256)
            plan = kh.plan(rows, cols, ty * tx, True)
            units = rows * cols // 4
            for name, x in frames.items():
                for per, spread in geometries_of(plan, options):
                    chunk = -(-units // per)
                    per = -(-units // chunk)

                    def call(per=per, chunk=chunk, spread=spread, x=x):
                        _build.check(hl.grid_histogram_f32(x.data_ptr(), 1, 1, Wh, rows, cols, ty, tx, 256, 0.0, 1.0,
                                                           1.0, inv_q, per, chunk, spread, tickets.data_ptr(),
                                                           counts.data_ptr(), out.data_ptr(), stream),
                                     "grid_histogram_f32")
                    call()
                    torch.cuda.synchronize()
                    chip_smoke.check(bool((out.reshape(refs[name, label].shape) == refs[name, label]).all()),
                                     f"grid_histogram {label} {name} at {per} blocks a tile, spread {spread}, "
                                     f"variant {variant}")
                    emit({"kernel": "grid_histogram", "case": label, "frame": name, "blocks_per_tile": per,
                          "spread": spread, "plan": (per, spread) == plan[::2], "variant": variant,
                          "ms": smoke.device_ms(call, iters=30)})

    def geometries(plan, options):
        # (blocks a tile, copies of a tile's counts): the plan's blocks at
        # other spreads, other blocks at the plan's rule for the spread
        return ([(plan[0], spread) for spread in sorted({1, plan[2], kh._MAX_SPREAD})]
                + [(per, min(kh._MAX_SPREAD, -(-per // kh._SPREAD_BLOCKS))) for per in options])

    checkout = _build.lib("histogram")
    sweep(checkout, "checkout", geometries)
    root = Path(tempfile.mkdtemp(prefix="histogram_variants_", dir=ROOT / "build"))
    try:
        variants = [("checkout", checkout, 1.0), ("quotient", checkout, 0.0)]
        variants += [(name, hl, 1.0) for name, hl in variant_libs(root, _build).items()]
        plan_only = lambda plan, options: [plan[::2]]  # noqa: E731
        for turn in range(2):
            for variant, hl, inv_q in variants:
                if turn or variant != "checkout":
                    sweep(hl, variant, plan_only, inv_q)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
