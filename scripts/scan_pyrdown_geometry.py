#!/usr/bin/env python3
"""Time grid_scan (csrc/scan.cu scan_rows_kernel) and pyrdown
(csrc/pyrdown.cu) at other geometries than their wrappers pick, and pyrdown
against variants of its source, side by side on one CUDA GPU.

    python3 scripts/scan_pyrdown_geometry.py [--out build/scan_pyrdown_geometry.json]

grid_scan: at CLAHE's 64x256 tile CDFs and a 480x640 frame, every warps a
block (1, 2, 4, 8) and every run a lane (4-32 floats) whose passes cover
the row, through the C entry point, each held to the plain version within
2e-6 of its largest value. pyrdown, reflect border: at the Sintel pyramid's
levels 0-2 (436x1024, 218x512, 109x256) and at 1080x1920 and 2160x3840, the
checkout's kernel (tiles of 4x32 outputs) and the VARIANTS of its source
that `variant_source` writes: "tile_TYxTX" (the kernel at another tile:
8x32, 8x64, 16x64), "two_pass" (the vertical sums at the even rows into
shared memory, a second barrier, then the horizontal sums) and "fold_loop"
(the reflect index folded by a loop that branches); all built into a
temporary directory under build/ that is removed at the end. Each call is held to the plain version bit for bit.
Times are chip_smoke's profiler timing (device ms per call, 30 calls,
L2-warm), beside the launch floor (`add_(1)` on one element). Prints one
JSON line per case, then the card's name and power limit. Compare
geometries only inside one run.
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
SCAN_SHAPES = [(64, 256), (480, 640)]
PYRDOWN_SHAPES = [(436, 1024), (218, 512), (109, 256), (1080, 1920), (2160, 3840)]
TILES = ((8, 32), (8, 64), (16, 64))
VARIANTS = (*(f"tile_{ty}x{tx}" for ty, tx in TILES), "two_pass", "fold_loop")
TWO_PASS = '''  // 2. the vertical sums at the even rows into shared memory, a barrier,
  // then the horizontal sums
  constexpr int U = 2 * TX + 3, VE = TX + 16, VW = VE + TX + 1;
  __shared__ float vsum[TY * VW];
#pragma unroll
  for (int l = 0; l < (TY * U + NT - 1) / NT; ++l) {
    const int e = tid + l * NT, r = e / U, u = e - r * U;
    if (e >= TY * U) break;
    const float* s = stage + 2 * r * SC + u + 2;
    float a = __fmul_rn(k[0], s[0]);
#pragma unroll
    for (int t = 1; t < 5; ++t) a = tap(a, k[t], s[t * SC]);
    vsum[r * VW + (u & 1) * VE + (u >> 1)] = a;
  }
  __syncthreads();
#pragma unroll
  for (int l = 0; l < (TY * TX + NT - 1) / NT; ++l) {
    const int e = tid + l * NT, r = e / TX, j = e - r * TX, oy = oy0 + r, ox = ox0 + j;
    if (oy >= Ho || ox >= Wo) continue;
    const float* ve = vsum + r * VW + j;
    const float* vo = ve + VE;
    float h = __fmul_rn(k[0], ve[0]);
    h = tap(h, k[1], vo[0]);
    h = tap(h, k[2], ve[1]);
    h = tap(h, k[3], vo[1]);
    h = tap(h, k[4], ve[2]);
    out[(size_t)oy * Wo + ox] = h;
  }
}
'''
FOLD_LOOP = '''  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * (n - 1) - i;
  return i;
'''


def variant_source(name: str, text: str) -> str:
    """csrc/pyrdown.cu with the change that makes variant `name`."""
    if name == "two_pass":
        a = text.index("  // 2. each output from the footprint")
        b = text.index("\n}\n", a) + 3  # the kernel's closing brace
        return text[:a] + TWO_PASS + text[b:]
    if name.startswith("tile_"):
        ty, tx = name[5:].split("x")
        old = "constexpr int TY = 4, TX = 32;"
        new = f"constexpr int TY = {ty}, TX = {tx};"
    else:
        old = "  const int m = 2 * (n - 1), a = abs(i);\n  return n <= 2 ? i & (n - 1) : max(min(a, m - a), 0);\n"
        new = FOLD_LOOP
    if text.count(old) != 1:
        raise RuntimeError(f"variant {name}: csrc/pyrdown.cu does not hold {old!r} once")
    return text.replace(old, new)


def variant_libs(root: Path, _build) -> dict:
    """The VARIANTS of csrc/pyrdown.cu, each built by its own nvcc (all
    started together) into root and loaded with the checkout's argtypes."""
    text = (_build.CSRC / "pyrdown.cu").read_text()
    procs = {}
    for name in VARIANTS:
        src, lib = root / f"pyrdown_{name}.cu", root / f"libpyrdown_{name}.so"
        src.write_text(variant_source(name, text))
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].pyrdown_f32.argtypes = _build.SIGNATURES["pyrdown"]["pyrdown_f32"]
        libs[name].pyrdown_f32.restype = ctypes.c_int
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "scan_pyrdown_geometry.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("scan_pyrdown_geometry: no CUDA device", file=sys.stderr)
        return 2
    from opencv_contrib_tpu_torch.ops.cuda import _build, pyramid, scan

    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(torch, dev)
    gen = np.random.default_rng(0)
    card = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)  # noqa: E731
    stream = _build.stream_of(torch.empty(1, device=dev))
    sms = _build.sm_count(dev)
    rows = [{"case": "launch_floor", "ms": timer.launch_floor_ms()}]
    print(json.dumps(rows[0]), flush=True)

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    lib = _build.lib("scan")
    for H, W in SCAN_SHAPES:
        x = card(gen.uniform(0, 255, size=(H, W)))
        ref = scan.grid_scan_plain(x)
        for warps in (1, 2, 4, 8):
            for run in scan._RUNS:
                if 32 * run * 4 < W:  # at most 4 passes
                    continue
                y = torch.empty_like(x)
                fn = lambda: _build.check(lib.scan_rows_f32(x.data_ptr(), y.data_ptr(), H, W, warps, run,  # noqa: E731
                                                             stream), "scan_rows_f32")
                fn()
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                chip_smoke.check(err <= 2e-6 * float(ref.abs().max()), f"grid_scan {H}x{W} {warps} {run}: {err}")
                emit({"case": "grid_scan", "shape": [H, W], "warps": warps, "run": run,
                      "plan": (warps, run) == scan.scan_plan(H, W, sms), "max_abs_err": err,
                      "ms": timer.device_ms(fn, iters=30)})

    tmp = Path(tempfile.mkdtemp(prefix="pyrdown_variants_", dir=ROOT / "build"))
    try:
        libs = {"checkout": _build.lib("pyrdown"), **variant_libs(tmp, _build)}
        for H, W in PYRDOWN_SHAPES:
            x = card(gen.uniform(0, 4, size=(H, W)))
            Ho, Wo = (H + 1) // 2, (W + 1) // 2
            ref = pyramid.pyrdown_plain(x)
            for name, lib in libs.items():
                out = torch.empty(Ho, Wo, device=dev)
                fn = lambda: _build.check(lib.pyrdown_f32(  # noqa: E731
                    x.data_ptr(), out.data_ptr(), H, W, pyramid.BORDERS["reflect101"], stream), "pyrdown_f32")
                fn()
                torch.cuda.synchronize()
                chip_smoke.check(torch.equal(out, ref), f"pyrdown {name} {H}x{W}: not the plain bits")
                emit({"case": "pyrdown", "source": name, "shape": [H, W], "ms": timer.device_ms(fn, iters=30)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
