#!/usr/bin/env python3
"""Smoke run of the PyTorch port (opencv_contrib_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

It builds the hand-written kernels from opencv_contrib_tpu_torch/ops/cuda/csrc
(first use, a few seconds of nvcc), holds each kernel against its plain
PyTorch version on the card, drives the port's main paths through the entry
points (`entry.frontend`, `entry.keyframe_tick`, `entry.kinfu_track`), and
checks their outputs.

Phases, one JSON line each:
  (a) build and launch checks at small ragged shapes;
  (b) knn2 against its plain version at 8192x8192x128 (the matcher bench),
      1000x3000x64 (ragged) and 512x512x64 (the keyframe tick's matches);
  (c) integral_image and grid_scan against their plain versions at 480x640
      and 2048x2048;
  (d) the two-frame frontend at VGA with K=512 (ratio_test_match and
      ratio_test_match_fused), with the launch counters set to 0 before it
      and read after it, and the kernel path against the plain path on the
      card and against the CPU;
  (e) the keyframe tick: 32 VGA frames at K=512, then bundle adjustment over
      16 cameras x 2048 points with 10 iterations, with the counters read
      the same way; keyframes/s and BA iterations/s;
  (f) where the tick's time goes: host time per stage, and the device's
      busy share and kernel times from torch.profiler;
  (g) grid_reduce_vec (the ICP getAb system) against its plain version on
      levels 0-2 of a 480x640 orbit frame, at identity and at a
      1 cm / 0.01 rad offset;
  (h) KinectFusion: the bench tick of bench.py::bench_kinfu_vga512 (VGA,
      512^3, 12288 sparse blocks; ms per tick and peak memory), an 8-frame
      VGA orbit through `entry.kinfu_track` with the counters read around it
      and held to the reference drift gates, the same orbit on the plain
      path, a small orbit on the card against the CPU, and the tick under
      torch.profiler, stage by stage through KinFu.update's
      record_function ranges;
  (i) the pyrdown kernel in both borders at 436x1024, 218x512, 109x256 (odd
      output) and 480x640, and the remap kernel in both contracts (max_disp
      4 and None) with C = 1 and 3 at 436x1024 and 55x128, each against its
      plain version and timed beside the nearest PyTorch call;
  (j) dense flow: `entry.dense_flow` with DIS and TV-L1 on `entry.flow_pair()`
      (MPI-Sintel's 436x1024) with the counters read around it, the interior
      EPE gates, the plain path, a 96x128 pair on the card against the CPU,
      ms per pair, peak memory, and one profiled pair per method.
Then one `kernels` JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Any failed check raises: the script
then exits non-zero and prints no last line.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

# (memory bytes/s, float32 CUDA-core FLOP/s) from NVIDIA's data sheets, by
# the device name CUDA reports; the SXM part is the default
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H200": (4.8e12, 67e12),
    "H100": (3.35e12, 67e12),
}
SOURCES = {  # kernel -> (CUDA source, the Pallas function it replaces)
    "knn2": ("opencv_contrib_tpu_torch/ops/cuda/csrc/knn2.cu", "opencv_contrib_tpu/ops/pallas/matching.py:73"),
    "integral_image": ("opencv_contrib_tpu_torch/ops/cuda/csrc/scan.cu",
                       "opencv_contrib_tpu/ops/pallas/grid.py:282"),
    "grid_scan": ("opencv_contrib_tpu_torch/ops/cuda/csrc/scan.cu", "opencv_contrib_tpu/ops/pallas/pipeline.py:35"),
    "grid_reduce_vec": ("opencv_contrib_tpu_torch/ops/cuda/csrc/reduce_vec.cu",
                        "opencv_contrib_tpu/ops/pallas/grid.py:155"),
    "pyrdown": ("opencv_contrib_tpu_torch/ops/cuda/csrc/pyrdown.cu", "opencv_contrib_tpu/ops/pallas/pipeline.py:87"),
    "remap": ("opencv_contrib_tpu_torch/ops/cuda/csrc/remap.cu", "opencv_contrib_tpu/ops/pallas/remap.py:41"),
}
# the kernels each main path runs; a kernel's launches are reported from the
# last path that runs it
PATH_KERNELS = {"frontend": ("knn2", "integral_image", "grid_scan"),
                "keyframe_tick": ("knn2", "integral_image", "grid_scan"), "kinfu_tick": ("grid_reduce_vec",),
                "dense_flow": ("pyrdown", "remap")}
LAUNCH_PATH = {k: path for path, ks in PATH_KERNELS.items() for k in ks}
DEVICE_KERNELS = ("knn2_kernel", "knn2_merge_kernel", "row_sqnorm_kernel", "scan_rows_kernel", "scan_cols_kernel",
                  "grid_reduce_vec_kernel", "icp_getab_finalize_kernel", "pyrdown_kernel", "remap_kernel")
PYRDOWN_SHAPES = [(436, 1024), (218, 512), (109, 256), (480, 640)]  # the Sintel pyramid's levels 0-2, and VGA
REMAP_SHAPES = [(436, 1024), (55, 128)]  # the Sintel pyramid's finest and coarsest levels
REMAP_FIELD_PX = 12.0  # smooth random displacements up to +-12 px leave the image at the borders
FLOW_METHODS = ("dis", "tvl1")
# per pair at 4 levels: pyrdown 3 per frame; remap once per outer iteration
# and level (DIS: 3 outer x 4 levels; TV-L1: 5 x 4)
FLOW_LAUNCHES = {"dis": {"pyrdown": 6, "remap": 12}, "tvl1": {"pyrdown": 6, "remap": 20}}
# interior (8 px border) EPE gates on entry.flow_pair(): about 1.35x the JAX
# package's own 0.0375 (DIS) and 0.0279 (TV-L1) on the same frames, on the CPU
FLOW_EPE_GATE = {"dis": 0.05, "tvl1": 0.04}
FLOW_PLAIN_TOL = 1e-3  # px, max abs, kernel path against the plain path on the card
# px, max abs, a 96x128 pair at 3 levels on the card against the CPU. The two
# round differently (reductions, matmuls), and TV-L1 carries an ulp to tenths
# of a pixel at the image border; phase j also reports the full-size pair on
# the card against the CPU, border and interior apart
FLOW_CPU_TOL = 1e-2
N_FLOW_TIMED = 5
KNN2_SHAPES = [(8192, 8192, 128), (1000, 3000, 64), (512, 512, 64)]
SCAN_SHAPES = [(480, 640), (2048, 2048)]
N_FRAMES, K, N_BA = 32, 512, 10
FRONTEND = dict(K=K, threshold=20.0, ratio=0.85)  # bench.py's keyframe settings
# The bench frames' float32 summed-area table reaches ~4e7 (ulp 4), so two
# summation orders already move Hessian responses by ~1% and reorder the
# top-K. Integer pixels with H * W * max < 2**24 sum exactly in any order:
# on such frames every path must find the same keypoints.
EXACT_LEVELS = 54  # 480 * 640 * 54 < 2**24
KINFU_INTR = [525.0, 525.0, 320.0, 240.0, 0, 0, 0, 0, 0]  # bench.py::bench_kinfu_vga512
KINFU_BENCH = dict(frame_shape=(480, 640), volume_resolution=(512, 512, 512), volume_size=3.0,
                   volume_center=(0.0, 0.0, 2.0), sparse_blocks=12288)
KINFU_ORBIT = dict(KINFU_BENCH, volume_size=3.2, volume_center=(0.0, 0.0, 2.2))  # tests/test_rgbd.py's scene
N_ORBIT, ORBIT_SWEEP = 8, 0.5
ICP_OFFSET = [0.01, 0.0, 0.0, 0.01, 0.0, 0.0]  # 0.01 rad about x, 1 cm along x
STAGE_PREFIX = "kinfu."  # KinFu.update's record_function ranges


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_events(prof):
    """Device-side profiler events only: a CPU op's device total repeats its
    kernels'. The device-side spans of KinFu's record_function ranges are
    left out too: they cover kernels that are already counted."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith(STAGE_PREFIX)]


def is_ours(key: str, kname: str) -> bool:
    return kname + "(" in key or kname + "<" in key


def getab_work(T, src, dst, intr, dist_thresh: float) -> dict:
    """How many pixels pass each gate of the getAb map (reduce_vec.cu
    IcpGetAb) on these frames, counted by the plain version's arithmetic:
    the bound counts the bytes and operations that this data needs."""
    import torch

    p = torch.einsum("ij,hwj->hwi", T[:3, :3], src.points) + T[:3, 3]
    z = torch.clamp(p[..., 2], min=1e-9)
    ui = torch.round(torch.addcmul(intr[2], p[..., 0] / z, intr[0])).long()
    vi = torch.round(torch.addcmul(intr[3], p[..., 1] / z, intr[1])).long()
    H, W = dst.valid.shape
    inb = src.valid & (p[..., 2] > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    flat = (torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)).reshape(-1)
    tv = inb & dst.valid.reshape(-1)[flat].reshape(inb.shape)
    diff = p - dst.points.reshape(-1, 3)[flat].reshape(p.shape)
    near = tv & (torch.sum(diff * diff, dim=-1) < dist_thresh * dist_thresh)
    return {"pixels": int(src.valid.numel()), "src_valid": int(src.valid.sum()), "in_target": int(inb.sum()),
            "target_valid": int(tv.sum()), "near": int(near.sum())}


def exact_frames(frames: np.ndarray, levels: int) -> np.ndarray:
    """Frames on 0..255 requantized to integers 0..levels."""
    return np.round(frames / 255.0 * levels).astype(np.float32)


@contextlib.contextmanager
def plain_path():
    """The port's path with each kernel call site switched to the plain
    version, on the same CUDA tensors. The library never makes that choice
    for a CUDA tensor, so this check makes it here, at the call sites."""
    from opencv_contrib_tpu_torch.features import match
    from opencv_contrib_tpu_torch.ops import integral
    from opencv_contrib_tpu_torch.ops.cuda import matching, pyramid, reduce, remap, scan

    def knn2(q, t, tile_q=512, tile_t=2048):
        return matching.knn2_plain(q, t, tile_q)

    with mock.patch.object(integral, "integral_image", scan.integral_image_plain), \
            mock.patch.object(match, "use_kernel", lambda x: False), \
            mock.patch.object(matching, "knn2", knn2), \
            mock.patch.object(reduce, "icp_getab", reduce.icp_getab_plain), \
            mock.patch.object(pyramid, "pyrdown", pyramid.pyrdown_plain), \
            mock.patch.object(remap, "remap", remap.remap_plain):
        yield


class Smoke:
    def __init__(self):
        import torch

        from opencv_contrib_tpu_torch import entry
        from opencv_contrib_tpu_torch.ops import cuda as kern

        self.torch, self.entry, self.kern = torch, entry, kern
        self.dev = torch.device("cuda", 0)
        self.name = torch.cuda.get_device_name(0)
        self.bw, self.flops = next((v for k, v in CARD_PEAKS.items() if k in self.name), CARD_PEAKS["H100"])
        self.gen = np.random.default_rng(0)
        self.frames = entry.make_frames(n_frames=N_FRAMES, H=480, W=640, seed=0)
        self.intr = np.asarray([500.0, 500.0, 320.0, 240.0, 0, 0, 0, 0, 0], np.float32)
        self.kernels = {}  # name -> timing row at the main path's shape
        self.launches = {}  # path -> launch counts

    def card(self, a):
        return self.torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.dev)

    def device_ms(self, fn, iters: int = 10) -> float:
        """Device time of one call: the durations of the kernels it ran, from
        torch.profiler, without the host time between them."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a trace now and then comes back without its device events
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            us = sum(e.self_device_time_total for e in kernel_events(prof))
            if us > 0:
                return us / iters / 1e3
        raise AssertionError("torch.profiler recorded no device time")

    def wall_ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        """Mean time of one call, from CUDA events around `iters` calls: the
        host's call rate where it cannot keep the device busy."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def times(self, fns: dict) -> dict:
        """`ms` (device) and `wall_ms` (events) of the kernel, its plain
        version and the library call, keyed by prefix."""
        out = {}
        for prefix, fn in fns.items():
            out[prefix + "ms"] = self.device_ms(fn)
            out[prefix + "wall_ms"] = self.wall_ms(fn, iters=20 if prefix != "plain_" else 5)
        return out

    def wall_s(self, fn):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def counted(self, path: str, fn):
        """Run one main path with the launch counters set to 0 before it and
        read after it; every kernel of that path must have launched."""
        self.kern.reset_launches()
        out = self.wall_s(fn)
        self.launches[path] = self.kern.launches()
        mine = {k: self.launches[path][k] for k in PATH_KERNELS[path]}
        check(all(v > 0 for v in mine.values()), f"{path} did not launch every kernel of its path: {mine}")
        return out

    # ---- (a) -----------------------------------------------------------------
    def build(self):
        from opencv_contrib_tpu_torch.ops.cuda import _build, pyramid, reduce, remap, scan
        from opencv_contrib_tpu_torch.ops.cuda import matching as fused
        from opencv_contrib_tpu_torch.rgbd import frame

        torch = self.torch
        t0 = time.perf_counter()
        libs = _build.build()
        build_s = time.perf_counter() - t0
        q, t = self.card(self.gen.normal(size=(70, 33))), self.card(self.gen.normal(size=(130, 33)))
        d, i = fused.knn2(q, t)
        dp, ip = fused.knn2_plain(q, t)
        x = self.card(self.gen.normal(size=(9, 130)))
        ii, gs = scan.integral_image(x), scan.grid_scan(x)
        torch.cuda.synchronize()
        check(torch.allclose(d, dp, rtol=1e-5, atol=1e-4) and bool((i == ip).all()), "knn2 launch check")
        err_ii = float((ii - scan.integral_image_plain(x)).abs().max())
        err_gs = float((gs - scan.grid_scan_plain(x)).abs().max())
        check(err_ii <= 1e-4 and err_gs <= 1e-4, f"scan launch check {err_ii} {err_gs}")
        it = self.card([30.0, 30.0, 14.0, 6.0, 0, 0, 0, 0, 0])
        f = frame.make_frame(self.card(self.gen.uniform(1.5, 2.5, size=(13, 29))), it, levels=1)[0]
        args = (torch.eye(4, device=self.dev), f.points, f.normals, f.valid, f.points, f.normals, f.valid, it, 0.1)
        (A, b, n, _), (Ap, bp, n_p, _) = reduce.icp_getab(*args), reduce.icp_getab_plain(*args)
        torch.cuda.synchronize()
        check(float(n) == float(n_p) > 0 and torch.allclose(A, Ap, rtol=1e-4, atol=1e-4 * float(Ap.abs().max()))
              and torch.allclose(b, bp, rtol=1e-4, atol=1e-4 * float(Ap.abs().max())),
              f"grid_reduce_vec launch check: n {float(n)} vs {float(n_p)}")
        img = self.card(self.gen.uniform(0, 4, size=(13, 29)))
        for border in pyramid.BORDERS:
            err = float((pyramid.pyrdown(img, border) - pyramid.pyrdown_plain(img, border)).abs().max())
            check(err <= 1e-6, f"pyrdown ({border}) launch check: {err}")
        maps = self.card(self.gen.uniform(0, 4, size=(3, 13, 29)))
        dy, dx = self.card(self.gen.uniform(-6, 6, size=(13, 29))), self.card(self.gen.uniform(-6, 6, size=(13, 29)))
        for max_disp in (2, None):
            err = float((remap.remap(maps, dy, dx, max_disp) - remap.remap_plain(maps, dy, dx, max_disp)).abs().max())
            check(err <= 1e-5, f"remap (max_disp {max_disp}) launch check: {err}")
        torch.cuda.synchronize()
        emit({"phase": "a_build", "build_s": build_s, "libraries": sorted(libs),
              "nvcc_flags": list(_build.NVCC_FLAGS), "ok": True})

    # ---- (b) -----------------------------------------------------------------
    def knn2(self):
        from opencv_contrib_tpu_torch.ops.cuda import matching as fused
        from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

        torch = self.torch
        rows = []
        for Q, Tn, D in KNN2_SHAPES:
            q, t = self.card(self.gen.normal(size=(Q, D))), self.card(self.gen.normal(size=(Tn, D)))
            with f32_matmul_precision():
                d, i = fused.knn2(q, t)
                dp, ip = fused.knn2_plain(q, t)
                torch.cuda.synchronize()
                err = float((d - dp).abs().max())
                worst = float(((d - dp).abs() / (1e-4 + 1e-5 * dp.abs())).max())
                agree = float((i == ip).float().mean())
                check(worst <= 1.0 and agree >= 0.999, f"knn2 {Q}x{Tn}x{D}: err/tol {worst}, idx agreement {agree}")
                fns = {"": lambda: fused.knn2(q, t), "plain_": lambda: fused.knn2_plain(q, t),
                       "library_": lambda: torch.topk(torch.cdist(q, t), 2, dim=1, largest=False)}
                times = self.times(fns)
            nbytes, ops = 4 * (Q * D + Tn * D + 3 * Q), 2 * Q * Tn * D
            rows.append({"shape": [Q, Tn, D], "max_abs_err": err, "err_over_tol": worst, "idx_agree": agree,
                         **times,
                         "bound_ms": max(nbytes / self.bw, ops / self.flops) * 1e3,
                         "bound_by": "operations" if ops / self.flops > nbytes / self.bw else "bytes",
                         "pairs_per_s": Q * Tn / (times["ms"] * 1e-3)})
        self.kernels["knn2"] = rows[0]
        emit({"phase": "b_knn2", "tolerance": "rtol 1e-5, atol 1e-4; idx agreement >= 0.999",
              "timing": "ms: device time per call (torch.profiler); wall_ms: CUDA events per call",
              "library_call": "torch.topk(torch.cdist(q, t), 2, largest=False)", "runs": rows, "ok": True})

    # ---- (c) -----------------------------------------------------------------
    def scan(self):
        from opencv_contrib_tpu_torch.ops.cuda import scan

        torch = self.torch
        rows = []
        for H, W in SCAN_SHAPES:
            x = self.card(self.gen.uniform(0, 255, size=(H, W)))
            for kname, fn, plain, library in (
                    ("integral_image", scan.integral_image, scan.integral_image_plain,
                     lambda a: torch.cumsum(torch.cumsum(a, 0), 1)),
                    ("grid_scan", scan.grid_scan, scan.grid_scan_plain, lambda a: torch.cumsum(a, 1))):
                out, ref = fn(x), plain(x)
                torch.cuda.synchronize()
                err, top = float((out - ref).abs().max()), float(ref.abs().max())
                check(err <= 2e-6 * top, f"{kname} {H}x{W}: max err {err} > 2e-6 * {top}")
                row = {"kernel": kname, "shape": [H, W], "max_abs_err": err, "max_abs": top,
                       **self.times({"": lambda: fn(x), "plain_": lambda: plain(x), "library_": lambda: library(x)}),
                       "bound_ms": 2 * 4 * H * W / self.bw * 1e3, "bound_by": "bytes"}
                rows.append(row)
                if (H, W) == SCAN_SHAPES[0]:
                    self.kernels[kname] = row
        emit({"phase": "c_scan", "tolerance": "max abs err <= 2e-6 * max|out|",
              "timing": "ms: device time per call (torch.profiler); wall_ms: CUDA events per call",
              "library_call": "torch.cumsum (twice for integral_image)", "runs": rows, "ok": True})

    # ---- (d) -----------------------------------------------------------------
    def stages(self, frames, device, threshold):
        """Detect, describe and match two frames with both matchers."""
        from opencv_contrib_tpu_torch.features import describe, detect, match
        from opencv_contrib_tpu_torch.ops.cuda import matching as fused
        from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

        out = []
        with f32_matmul_precision():
            for a in frames:
                img = self.torch.from_numpy(a).to(device)
                k = detect.fast_hessian(img, max_keypoints=K, threshold=threshold)
                out.append((k, describe.surf_describe(img, k)))
            (k1, d1), (k2, d2) = out
            m = match.ratio_test_match(d1, d2, k1.valid, k2.valid, ratio=FRONTEND["ratio"])
            mf = fused.ratio_test_match_fused(d1, d2, k1.valid, k2.valid, ratio=FRONTEND["ratio"])
        return k1, d1, m, mf

    def frontend(self):
        torch, entry, f = self.torch, self.entry, self.frames
        entry.frontend(f[0], f[1], **FRONTEND)  # warm-up: cuBLAS, allocator

        def main_path():
            n, _, _ = entry.frontend(f[0], f[1], **FRONTEND)
            _, _, m, mf = self.stages(f[:2], self.dev, FRONTEND["threshold"])
            return int(n), int(m.valid.sum()), int(mf.valid.sum())

        (n, n_m, n_mf), s = self.counted("frontend", main_path)
        check(n == n_m and n >= K // 4, f"frontend matches {n} vs {n_m}")
        with plain_path():
            n_p, _, _ = entry.frontend(f[0], f[1], **FRONTEND)
            _, _, _, mf_p = self.stages(f[:2], self.dev, FRONTEND["threshold"])

        ex = exact_frames(f[:2], EXACT_LEVELS)
        thr = FRONTEND["threshold"] * (EXACT_LEVELS / 255.0) ** 2
        k1, d1, m, mf = self.stages(ex, self.dev, thr)
        with plain_path():
            plain = self.stages(ex, self.dev, thr)
        host = self.stages(ex, torch.device("cpu"), thr)
        cmp = {}
        for label, ref in (("plain_on_card", plain), ("cpu", host)):
            rk1, rd1, rm, rmf = (v.to(self.dev) if isinstance(v, torch.Tensor) else
                                 type(v)(*(x.to(self.dev) for x in v)) for v in ref)
            check(bool((k1.valid == rk1.valid).all()), f"keypoint valid masks differ ({label})")
            for fld in ("y", "x", "scale", "response"):
                check(torch.allclose(getattr(k1, fld), getattr(rk1, fld), rtol=1e-4, atol=1e-3),
                      f"keypoint {fld} differs ({label})")
            ang = torch.remainder(k1.angle - rk1.angle + np.pi, 2 * np.pi) - np.pi
            both = m.valid & rm.valid
            c = {"valid_kp": int(k1.valid.sum()), "angle_max_diff": float(ang.abs().max()),
                 "desc_max_diff": float((d1 - rd1).abs().max()),
                 "matches": int(m.valid.sum()), "matches_ref": int(rm.valid.sum()),
                 "fused_matches": int(mf.valid.sum()), "fused_matches_ref": int(rmf.valid.sum()),
                 "train_idx_agree": float((m.train_idx == rm.train_idx)[both].float().mean())}
            check(c["angle_max_diff"] < 1e-3 and c["desc_max_diff"] < 1e-4, f"orientation/descriptor ({label}): {c}")
            for a, b in (("matches", "matches_ref"), ("fused_matches", "fused_matches_ref")):
                check(abs(c[a] - c[b]) <= max(2, 0.01 * c[b]), f"{a} ({label}): {c}")
            check(c["train_idx_agree"] >= 0.99 and c["matches"] >= K // 4, f"matches ({label}): {c}")
            cmp[label] = c
        emit({"phase": "d_frontend", "frames": [2, 480, 640], **FRONTEND, "s_main_path": s,
              "launches": self.launches["frontend"], "matches": n, "matches_fused": n_mf,
              "plain_path": {"matches": int(n_p), "matches_fused": int(mf_p.valid.sum())},
              "exact_frames": {"levels": EXACT_LEVELS, "threshold": thr, **cmp},
              "tolerance": "exact frames: equal valid masks; y/x/scale/response rtol 1e-4 atol 1e-3; "
                           "angle 1e-3; descriptors 1e-4; match counts within 1% or 2; train_idx >= 0.99",
              "ok": True})

    # ---- (e) -----------------------------------------------------------------
    def tick(self):
        from opencv_contrib_tpu_torch.ba import bundle

        torch, entry = self.torch, self.entry
        # a small input on the card against the CPU, on exactly summable
        # frames (integer pixels: 128 * 160 * 255 < 2**24)
        small = exact_frames(entry.make_frames(n_frames=3, H=128, W=160, seed=0), 255)
        intr_s = np.asarray([500.0, 500.0, 80.0, 64.0, 0, 0, 0, 0, 0], np.float32)
        kw = dict(K=64, n_ba=1, ba_views=4, ba_points=64)
        tc = entry.keyframe_tick(small, intr_s, **kw)
        th = entry.keyframe_tick(small, intr_s, device="cpu", **kw)
        d_ok = int((tc.n_ok.cpu() - th.n_ok).abs().max())
        rel = abs(float(tc.ba.final_cost) / float(th.ba.final_cost) - 1.0)
        check(d_ok <= 1 and rel <= 1e-3 and bool(torch.isfinite(tc.ts).all()),
              f"small tick: card n_ok {tc.n_ok.tolist()} vs cpu {th.n_ok.tolist()}, BA rel {rel}")

        entry.keyframe_tick(self.frames[:2], self.intr, K=K, n_ba=1)  # warm-up: cuSOLVER, allocator
        tick, s_tick = self.counted("keyframe_tick",
                                    lambda: entry.keyframe_tick(self.frames, self.intr, K=K, n_ba=N_BA))
        check(tuple(tick.ts.shape) == (N_FRAMES, 3) and bool(torch.isfinite(tick.ts).all()), "tick ts")
        n_ok = tick.n_ok.cpu()
        check(int(n_ok.min()) >= K // 4, f"too few matches per frame: {n_ok.tolist()}")
        c0, c1 = float(tick.ba.initial_cost), float(tick.ba.final_cost)
        check(np.isfinite(c1) and c1 < 1e-3 * c0, f"BA did not converge: {c0} -> {c1}")
        prob = entry.ba_problem(16, 2048, device=self.dev)
        rms = float(bundle.rms_reprojection_error(tick.ba.cameras, tick.ba.points, tick.ba.intr,
                                                  prob.obs, prob.mask))
        check(rms < 0.05, f"BA rms reprojection {rms} px")
        bundle.bundle_adjust(prob, n_iters=N_BA)
        _, s_ba = self.wall_s(lambda: bundle.bundle_adjust(prob, n_iters=N_BA))
        emit({"phase": "e_keyframe_tick", "frames": [N_FRAMES + 1, 480, 640], "K": K,
              "ba": {"views": 16, "points": 2048, "iters": N_BA, "initial_cost": c0, "final_cost": c1,
                     "rms_px": rms},
              "s_tick": s_tick, "s_ba": s_ba, "keyframes_per_s": N_FRAMES / s_tick,
              "ba_iters_per_s": N_BA / s_ba, "n_ok_min": int(n_ok.min()), "n_ok_mean": float(n_ok.float().mean()),
              "launches": self.launches["keyframe_tick"],
              "small_vs_cpu": {"n_ok_card": tc.n_ok.tolist(), "n_ok_cpu": th.n_ok.tolist(), "ba_rel": rel},
              "ok": True})

    # ---- (f) -----------------------------------------------------------------
    def profile(self, n: int = 4):
        from torch.profiler import ProfilerActivity, profile

        from opencv_contrib_tpu_torch.ba import bundle
        from opencv_contrib_tpu_torch.core import camera as cam
        from opencv_contrib_tpu_torch.features import describe, detect, match
        from opencv_contrib_tpu_torch.mvg import resection
        from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

        torch, entry = self.torch, self.entry
        intr = self.card(self.intr)
        stage_s = {"detect": 0.0, "describe": 0.0, "match": 0.0, "resect": 0.0}

        def timed(stage, fn):
            out, s = self.wall_s(fn)
            stage_s[stage] += s
            return out

        with f32_matmul_precision():  # the stages of entry.track_frames, timed one by one
            prev = None
            for a in self.frames[:n + 1]:
                img = self.card(a)
                k = timed("detect", lambda: detect.fast_hessian(img, max_keypoints=K, threshold=20.0))
                d = timed("describe", lambda: describe.surf_describe(img, k))
                xy = torch.stack([k.x, k.y], dim=1)
                if prev is not None:
                    pd, pv, pxyz = prev
                    m = timed("match", lambda: match.ratio_test_match(pd, d, pv, k.valid, ratio=0.85))

                    def resect():
                        xn = cam.normalize_points(intr, xy[m.train_idx.long()])
                        ok = m.valid & pv
                        R0, t0 = resection.pnp_dlt(pxyz, xn, mask=ok)
                        return resection.refine_pose(R0, t0, pxyz, xn, ok, iters=5)

                    timed("resect", resect)
                xn = cam.normalize_points(intr, xy)
                prev = (d, k.valid, torch.cat([xn, torch.ones_like(xn[:, :1])], dim=1))

        prob = entry.ba_problem(16, 2048, device=self.dev)
        imgs = self.card(self.frames[:n + 1])
        for what, fn in (("track_frames", lambda: entry.track_frames(imgs, intr, K)),
                         ("bundle_adjust", lambda: bundle.bundle_adjust(prob, n_iters=N_BA))):
            fn()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall = self.wall_s(fn)
            ev = kernel_events(prof)
            busy_us = sum(e.self_device_time_total for e in ev)
            top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
            ours = {}
            for e in ev:
                for kname in DEVICE_KERNELS:
                    if is_ours(e.key, kname):
                        ours[kname] = {"count": e.count, "us_per_launch": e.self_device_time_total / e.count}
            row = {"phase": f"f_profile_{what}", "wall_s_under_profiler": wall,
                   "device_busy_s": busy_us * 1e-6, "device_busy_share": busy_us * 1e-6 / wall,
                   "top_device": [{"name": e.key[:80], "count": e.count, "us": e.self_device_time_total}
                                  for e in top],
                   "our_kernels": ours}
            if what == "track_frames":
                row.update(frames=n, host_s_per_frame={k: v / n for k, v in stage_s.items()})
            emit(row)

    # ---- (g) -----------------------------------------------------------------
    def orbit_depths(self, shape=(480, 640), intr=KINFU_INTR):
        """Depth frames of the reference orbit, rendered on the card."""
        from opencv_contrib_tpu_torch.utils import sdf_scene

        poses = sdf_scene.orbit_poses(N_ORBIT, sweep=ORBIT_SWEEP)
        it = self.card(intr)
        return poses, self.torch.stack([sdf_scene.render_depth(self.card(p), it, shape=shape) for p in poses])

    def reduce_vec(self):
        from opencv_contrib_tpu_torch.core import se3
        from opencv_contrib_tpu_torch.ops.cuda import reduce
        from opencv_contrib_tpu_torch.rgbd import frame

        torch = self.torch
        _, depths = self.orbit_depths()
        intr = self.card(KINFU_INTR)
        dst = frame.make_frame(depths[0], intr)
        src = frame.make_frame(depths[1], intr)
        offset = se3.exp_se3(self.card(ICP_OFFSET))
        rows = []
        for lvl in range(3):
            it = frame.level_intrinsics(intr, lvl)
            s, d = src[lvl], dst[lvl]
            H, W = s.valid.shape
            for label, T in (("identity", torch.eye(4, device=self.dev)), ("offset", offset)):
                args = (T, s.points, s.normals, s.valid, d.points, d.normals, d.valid, it, 0.1 * (1 << lvl))
                A, b, n, err = reduce.icp_getab(*args)
                Ap, bp, n_p, errp = reduce.icp_getab_plain(*args)
                torch.cuda.synchronize()
                dn = abs(float(n) - float(n_p))
                errA = float((A - Ap).abs().max() / Ap.abs().max())
                errb = float((b - bp).abs().max() / bp.abs().max())
                check(dn <= max(3.0, 1e-3 * float(n_p)) and errA <= 1e-4 and errb <= 1e-4,
                      f"grid_reduce_vec level {lvl} {label}: n {float(n)} vs {float(n_p)}, A {errA}, b {errb}")
                work = getab_work(T, s, d, it, 0.1 * (1 << lvl))
                # bytes: what the map reads at each of its gates (the source's valid
                # flag for every pixel, its point where valid, the target's flag where
                # the point projects inside the target, its point where that is valid,
                # both normals where the distance gate passes), T, intr and the 44
                # outputs; operations: 24 flops to transform and project a valid
                # source point, 8 for the distance gate, 20 for the normal gate, 71 to
                # add a correspondence
                nbytes = (H * W + 12 * work["src_valid"] + work["in_target"] + 12 * work["target_valid"]
                          + 24 * work["near"] + 4 * (16 + 9 + 44))
                ops = 24 * work["src_valid"] + 8 * work["target_valid"] + 20 * work["near"] + 71 * int(n_p)
                row = {"level": lvl, "T": label, "shape": [H, W], "n_corr": float(n), "n_corr_plain": float(n_p),
                       "A_err_over_max": errA, "b_err_over_max": errb,
                       "max_abs_err": max(float((A - Ap).abs().max()), float((b - bp).abs().max())),
                       **self.times({"": lambda: reduce.icp_getab(*args), "plain_": lambda: reduce.icp_getab_plain(*args)}),
                       "library_ms": None, "bound_ms": max(nbytes / self.bw, ops / self.flops) * 1e3,
                       "bound_by": "operations" if ops / self.flops > nbytes / self.bw else "bytes",
                       "bytes": nbytes, "ops": ops, "work": work}
                rows.append(row)
                if lvl == 0 and label == "offset":
                    self.kernels["grid_reduce_vec"] = row
        emit({"phase": "g_reduce_vec", "tolerance": "n_corr within max(3, 0.1%); A, b within 1e-4 of max|A|, max|b|",
              "timing": "ms: device time per call (torch.profiler); wall_ms: CUDA events per call",
              "library_call": None, "runs": rows, "ok": True})

    # ---- (h) -----------------------------------------------------------------
    def kinfu(self):
        from opencv_contrib_tpu_torch.core import se3
        from opencv_contrib_tpu_torch.rgbd import kinfu

        torch, entry = self.torch, self.entry
        # 1. the bench tick (bench.py::bench_kinfu_vga512): 2 synced updates, 5 timed unsynced
        frames = entry.kinfu_bench_frames(7)
        p = kinfu.KinFuParams(intr=np.asarray(KINFU_INTR, np.float32), **KINFU_BENCH)
        kf = kinfu.KinFu(p)
        t0 = time.perf_counter()
        ok_warm = [kf.update(frames[0], sync=True), kf.update(frames[1], sync=True)]
        warm_s = time.perf_counter() - t0
        check(all(ok_warm), f"bench tick lost tracking in warm-up: {ok_warm}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(5):
            kf.update(frames[i + 2], sync=False)
        torch.cuda.synchronize()
        ms_tick = (time.perf_counter() - t0) / 5 * 1e3
        peak = torch.cuda.max_memory_allocated()
        check(bool(kf.last_ok) and bool(torch.isfinite(kf.T_cw).all()), "bench tick: tracking lost or non-finite pose")
        bench = {"ms_per_tick": ms_tick, "warmup_s": warm_s, "peak_mem_allocated_gb": peak / 2 ** 30,
                 "final_T_cw": kf.T_cw.cpu().tolist()}
        self.bench_kf = kf

        # 2. the VGA orbit through the entry point, counters read around it
        poses, depths = self.orbit_depths()
        kw = dict(intr=KINFU_INTR, **KINFU_ORBIT)
        entry.kinfu_track(depths[:2], **kw)  # warm-up: cuSOLVER, allocator
        track, s_orbit = self.counted("kinfu_tick", lambda: entry.kinfu_track(depths, **kw))
        drift = self.drift(poses, track.T_cw[-1])
        ok = track.ok.cpu().tolist()
        check(all(ok), f"orbit lost tracking: {ok}")
        check(drift["rot"] < 0.02 and drift["trans"] < 0.1, f"orbit drift {drift}")
        per_tick = self.launches["kinfu_tick"]["grid_reduce_vec"] / (N_ORBIT - 1)
        check(per_tick == sum(kinfu.KinFuParams.icp_iterations), f"grid_reduce_vec launches per tick {per_tick}")

        # 3. the same orbit on the plain path
        with plain_path():
            plain = entry.kinfu_track(depths, **kw)
        d = se3.log_se3(se3.inverse(track.T_cw[-1]) @ plain.T_cw[-1])
        vs_plain = {"rot": float(torch.linalg.norm(d[:3])), "trans": float(torch.linalg.norm(d[3:]))}
        check(vs_plain["rot"] < 1e-3 and vs_plain["trans"] < 1e-3 and all(plain.ok.cpu().tolist()),
              f"plain path differs from the kernel path: {vs_plain}")

        # 4. a small orbit on the card against the CPU
        small_intr = [120.0, 120.0, 80.0, 60.0, 0, 0, 0, 0, 0]
        _, small = self.orbit_depths(shape=(120, 160), intr=small_intr)
        skw = dict(intr=small_intr, frame_shape=(120, 160), volume_resolution=(96, 96, 96), volume_size=3.2,
                   volume_center=(0.0, 0.0, 2.2), sparse_blocks=None)
        card = entry.kinfu_track(small[:4], **skw)
        host = entry.kinfu_track(small[:4].cpu(), device="cpu", **skw)
        d = se3.log_se3(se3.inverse(host.T_cw[-1]) @ card.T_cw[-1].cpu())
        vs_cpu = {"rot": float(torch.linalg.norm(d[:3])), "trans": float(torch.linalg.norm(d[3:]))}
        check(vs_cpu["rot"] < 1e-4 and vs_cpu["trans"] < 1e-4, f"small orbit, card vs CPU: {vs_cpu}")
        emit({"phase": "h_kinfu", "bench_tick": {**KINFU_BENCH, "frames": [7, 480, 640], **bench},
              "orbit": {**KINFU_ORBIT, "frames": [N_ORBIT, 480, 640], "s": s_orbit,
                        "ms_per_frame": s_orbit / N_ORBIT * 1e3, "drift": drift, "ok": ok},
              "plain_path_vs_kernel": vs_plain, "small_orbit_card_vs_cpu": vs_cpu,
              "launches": self.launches["kinfu_tick"], "grid_reduce_vec_per_tick": per_tick,
              "tolerance": "drift rot < 0.02, trans < 0.1 m; plain path within 1e-3; card vs CPU within 1e-4",
              "ok": True})

    def drift(self, poses, T_cw_last):
        """Pose drift of the last frame against the orbit's truth, modulo the
        first frame (KinFu's world is the first camera frame)."""
        from opencv_contrib_tpu_torch.core import se3

        torch = self.torch
        T_gt = se3.inverse(self.card(poses[0])) @ self.card(poses[-1])
        d = se3.log_se3(se3.inverse(T_gt) @ se3.inverse(T_cw_last))
        return {"rot": float(torch.linalg.norm(d[:3])), "trans": float(torch.linalg.norm(d[3:]))}

    def profile_kinfu(self, n: int = 2):
        """The bench tick under torch.profiler: device busy share, top device
        operations, and the number of kernel launches per tick."""
        from torch.profiler import ProfilerActivity, profile

        kf, self.bench_kf = self.bench_kf, None  # the 1 GB volume goes with this phase
        frames = self.entry.kinfu_bench_frames(7 + n)[7:]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = self.wall_s(lambda: [kf.update(f, sync=False) for f in frames])
        ev = kernel_events(prof)
        busy_us = sum(e.self_device_time_total for e in ev)
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:10]
        ours = {k: {"count": e.count, "us_per_launch": e.self_device_time_total / e.count}
                for e in ev for k in DEVICE_KERNELS if is_ours(e.key, k)}
        emit({"phase": "h_profile_kinfu_tick", "ticks": n, "wall_s_under_profiler": wall,
              "stages_per_tick": self.kinfu_stages(prof, n),
              "device_busy_s": busy_us * 1e-6, "device_busy_share": busy_us * 1e-6 / wall,
              "device_launches_per_tick": sum(e.count for e in ev) / n,
              "top_device": [{"name": e.key[:80], "count": e.count, "us": e.self_device_time_total} for e in top],
              "our_kernels": ours})

    @staticmethod
    def kinfu_stages(prof, n: int) -> dict:
        """Per tick, for each of KinFu.update's record_function ranges: the
        host ms inside it, and the device ms and launches of the kernels
        launched inside it (the ticks run unsynchronised, so the host and the
        device columns overlap in time)."""
        def kernels(e):
            return [k for k in e.kernels if not k.name.startswith(STAGE_PREFIX)] + \
                [k for c in e.cpu_children for k in kernels(c)]

        from torch.autograd import DeviceType

        out = {}
        for e in prof.events():
            if e.name.startswith(STAGE_PREFIX) and e.device_type == DeviceType.CPU:
                ks = kernels(e)
                row = out.setdefault(e.name[len(STAGE_PREFIX):], {"host_ms": 0.0, "device_ms": 0.0, "launches": 0})
                row["host_ms"] += e.cpu_time_total / 1e3 / n
                row["device_ms"] += sum(k.duration for k in ks) / 1e3 / n
                row["launches"] += len(ks) / n
        check(set(out) == {"make_frame", "icp", "integrate", "raycast"}, f"KinFu stage ranges: {sorted(out)}")
        return out

    # ---- (i) -----------------------------------------------------------------
    def smooth_field(self, H: int, W: int, amp: float):
        """A smooth random displacement (H, W) on the card, |d| <= amp: coarse
        normal noise, upsampled bilinearly."""
        from opencv_contrib_tpu_torch.ops.image import resize

        torch = self.torch
        g = torch.from_numpy(self.gen.standard_normal((H // 16 + 2, W // 16 + 2)).astype(np.float32))
        f = resize(g, (H, W))
        return (amp * f / f.abs().max()).to(self.dev)

    def pyrdown_remap(self):
        import torch.nn.functional as F

        from opencv_contrib_tpu_torch.ops.cuda import pyramid, remap
        from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

        torch = self.torch
        k = pyramid.pyr_kernel(self.dev)
        w2d = torch.outer(k, k)[None, None]
        pyr_rows, remap_rows = [], []
        with f32_matmul_precision():  # cuDNN's convolution in full f32 too
            for H, W in PYRDOWN_SHAPES:
                x = self.card(self.gen.uniform(0, 4, size=(H, W)))
                Ho, Wo = (H + 1) // 2, (W + 1) // 2
                for border in pyramid.BORDERS:
                    out, ref = pyramid.pyrdown(x, border), pyramid.pyrdown_plain(x, border)
                    xp = F.pad(x[None, None], (2, 2, 2, 2), mode="reflect" if border == "reflect101" else "replicate")
                    lib_out = F.conv2d(xp, w2d, stride=2)[0, 0]
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    check(tuple(out.shape) == (Ho, Wo) and err <= 1e-6, f"pyrdown {border} {H}x{W}: max err {err}")
                    # bytes: the input read once, the output written once; operations:
                    # 9 for each of the 5 vertical sums and 9 for the horizontal one
                    nbytes, ops = 4 * (H * W + Ho * Wo), 54 * Ho * Wo
                    row = {"border": border, "shape": [H, W], "out_shape": [Ho, Wo], "max_abs_err": err,
                           "library_max_abs_diff": float((lib_out - ref).abs().max()),
                           **self.times({"": lambda: pyramid.pyrdown(x, border),
                                         "plain_": lambda: pyramid.pyrdown_plain(x, border),
                                         "library_": lambda: F.conv2d(xp, w2d, stride=2)}),
                           "bound_ms": max(nbytes / self.bw, ops / self.flops) * 1e3,
                           "bound_by": "operations" if ops / self.flops > nbytes / self.bw else "bytes"}
                    pyr_rows.append(row)
                    if (H, W) == PYRDOWN_SHAPES[0] and border == "reflect101":
                        self.kernels["pyrdown"] = row
            for H, W in REMAP_SHAPES:
                dy, dx = self.smooth_field(H, W, REMAP_FIELD_PX), self.smooth_field(H, W, REMAP_FIELD_PX)
                y = torch.arange(H, dtype=torch.float32, device=self.dev)[:, None]
                x = torch.arange(W, dtype=torch.float32, device=self.dev)[None, :]
                for C in (1, 3):
                    maps = self.card(self.gen.uniform(0, 4, size=(C, H, W)))
                    for max_disp in (4, None):
                        out, ref = remap.remap(maps, dy, dx, max_disp), remap.remap_plain(maps, dy, dx, max_disp)
                        # the library call: grid_sample's border padding clamps each
                        # coordinate to the image; the bounded contract's clip is applied
                        # to the displacement outside the timed call
                        lim = float("inf") if max_disp is None else float(max_disp)
                        gy, gx = y + dy.clamp(-lim, lim), x + dx.clamp(-lim, lim)
                        grid = torch.stack([gx * (2.0 / (W - 1)) - 1.0, gy * (2.0 / (H - 1)) - 1.0], dim=-1)[None]

                        def library():
                            return F.grid_sample(maps[None], grid, mode="bilinear", padding_mode="border",
                                                 align_corners=True)

                        torch.cuda.synchronize()
                        err = float((out - ref).abs().max())
                        check(err <= 1e-5, f"remap C={C} max_disp={max_disp} {H}x{W}: max err {err}")
                        leaves = float(((y + dy < 0) | (y + dy > H - 1) | (x + dx < 0) | (x + dx > W - 1))
                                       .float().mean())
                        # bytes: dy and dx read once, C maps read once and C written once;
                        # operations: about 14 for the coordinates and weights, 7 per map
                        nbytes, ops = (8 + 8 * C) * H * W, (14 + 7 * C) * H * W
                        row = {"max_disp": max_disp, "C": C, "shape": [H, W], "max_abs_err": err,
                               "field_px": REMAP_FIELD_PX, "share_outside_image": leaves,
                               "library_max_abs_diff": float((library()[0] - ref).abs().max()),
                               **self.times({"": lambda: remap.remap(maps, dy, dx, max_disp),
                                             "plain_": lambda: remap.remap_plain(maps, dy, dx, max_disp),
                                             "library_": library}),
                               "bound_ms": max(nbytes / self.bw, ops / self.flops) * 1e3,
                               "bound_by": "operations" if ops / self.flops > nbytes / self.bw else "bytes"}
                        remap_rows.append(row)
                        if (H, W) == REMAP_SHAPES[0] and C == 3 and max_disp is None:
                            self.kernels["remap"] = row
        emit({"phase": "i_pyrdown_remap",
              "tolerance": "pyrdown: max abs err <= 1e-6 on inputs in [0, 4) (the kernel rounds as the plain "
                           "version: 0 expected); remap: <= 1e-5 on maps in [0, 4)",
              "timing": "ms: device time per call (torch.profiler); wall_ms: CUDA events per call",
              "library_call": {"pyrdown": "F.conv2d(reflect- or edge-padded input, 5x5 binomial, stride=2), "
                                          "the pad outside the timed call",
                               "remap": "F.grid_sample(bilinear, padding_mode=border, align_corners=True), the "
                                        "grid and the bounded contract's clip outside the timed call"},
              "pyrdown": pyr_rows, "remap": remap_rows, "ok": True})

    # ---- (j) -----------------------------------------------------------------
    def dense_flow(self):
        from opencv_contrib_tpu_torch.flow import dis

        torch, entry = self.torch, self.entry
        I0, I1, gt = entry.flow_pair()
        gt_c = self.card(gt)

        def interior_epe(flow):
            return float(dis.epe(flow[8:-8, 8:-8], gt_c[8:-8, 8:-8]))

        for m in FLOW_METHODS:  # warm-up: cuBLAS, allocator
            entry.dense_flow(I0, I1, m)
        split = {}

        def main_path():
            out = {}
            for m in FLOW_METHODS:
                before = self.kern.launches()
                out[m] = entry.dense_flow(I0, I1, m)
                after = self.kern.launches()
                split[m] = {k: after[k] - before[k] for k in PATH_KERNELS["dense_flow"]}
            return out

        flows, s = self.counted("dense_flow", main_path)
        check(split == FLOW_LAUNCHES, f"dense-flow launches {split}, expected {FLOW_LAUNCHES}")
        res = {}
        with plain_path():
            plain = {m: entry.dense_flow(I0, I1, m) for m in FLOW_METHODS}
        Is0, Is1, _ = entry.flow_pair(96, 128)
        for m in FLOW_METHODS:
            f = flows[m]
            check(tuple(f.shape) == (436, 1024, 2) and bool(torch.isfinite(f).all()), f"{m}: flow shape / finite")
            epe = interior_epe(f)
            check(epe <= FLOW_EPE_GATE[m], f"{m}: interior EPE {epe} > {FLOW_EPE_GATE[m]}")
            d_plain = float((f - plain[m]).abs().max())
            check(d_plain <= FLOW_PLAIN_TOL, f"{m}: plain path differs by {d_plain} px")
            card = entry.dense_flow(Is0, Is1, m, levels=3).cpu()
            host = entry.dense_flow(Is0, Is1, m, device="cpu", levels=3)
            d_cpu = float((card - host).abs().max())
            check(d_cpu <= FLOW_CPU_TOL, f"{m}: 96x128 pair, card vs CPU {d_cpu} px")
            # the full-size pair on the CPU: how far rounding alone moves the field
            host_full = entry.dense_flow(I0, I1, m, device="cpu")
            diff = (f.cpu() - host_full).abs().amax(dim=-1)
            worst = int(diff.argmax())
            full_vs_cpu = {"max_abs": float(diff.max()), "argmax_yx": [worst // diff.shape[1], worst % diff.shape[1]],
                           "interior_max_abs": float(diff[8:-8, 8:-8].max()), "mean_abs": float(diff.mean()),
                           "epe_interior_cpu": float(dis.epe(host_full[8:-8, 8:-8], torch.from_numpy(gt[8:-8, 8:-8])))}
            ms = []
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()  # what the script holds already (this phase's flows)
            torch.cuda.reset_peak_memory_stats()
            for _ in range(N_FLOW_TIMED):
                _, t = self.wall_s(lambda: entry.dense_flow(I0, I1, m))
                ms.append(t * 1e3)
            res[m] = {"epe_interior": epe, "epe_gate": FLOW_EPE_GATE[m], "epe_plain_path": interior_epe(plain[m]),
                      "plain_path_max_abs_diff": d_plain, "small_card_vs_cpu_max_abs_diff": d_cpu,
                      "full_card_vs_cpu": full_vs_cpu,
                      "launches": split[m], "ms_per_pair_median": float(np.median(ms)), "ms_per_pair": ms,
                      "peak_mem_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "peak_mem_of_a_pair_gb": (torch.cuda.max_memory_allocated() - held) / 2 ** 30,
                      "profile": self.profile_pair(I0, I1, m)}
        emit({"phase": "j_dense_flow", "frames": [2, 436, 1024], "pair": "entry.flow_pair(): rotation 0.01 rad "
              "about the center + shift (3, -5) px, texture of tests/test_flow.py",
              "params": {"dis": "levels 4, stride 8, radius 8, 12 LK iterations, 3 x 30 Jacobi sweeps",
                         "tvl1": "levels 4, 5 outer x 30 inner iterations"},
              "s_main_path": s, "launches": self.launches["dense_flow"], **res,
              "tolerance": f"interior EPE (8 px border) <= {FLOW_EPE_GATE}; plain path within {FLOW_PLAIN_TOL} px; "
                           f"96x128 at 3 levels, card vs CPU within {FLOW_CPU_TOL} px (max abs)",
              "timing": f"ms_per_pair: host clock around one synchronised pair, {N_FLOW_TIMED} warm runs",
              "ok": True})

    def profile_pair(self, I0, I1, method: str) -> dict:
        """One pair under torch.profiler: device busy share, device launches,
        top device operations and the two kernels' launches."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = self.wall_s(lambda: self.entry.dense_flow(I0, I1, method))
        ev = kernel_events(prof)
        busy_us = sum(e.self_device_time_total for e in ev)
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:10]
        return {"wall_s_under_profiler": wall, "device_busy_s": busy_us * 1e-6,
                "device_busy_share": busy_us * 1e-6 / wall, "device_launches": sum(e.count for e in ev),
                "top_device": [{"name": e.key[:80], "count": e.count, "us": e.self_device_time_total} for e in top],
                "our_kernels": {k: {"count": e.count, "us_per_launch": e.self_device_time_total / e.count}
                                for e in ev for k in DEVICE_KERNELS if is_ours(e.key, k)}}

    def kernels_line(self):
        line = []
        for name, row in self.kernels.items():
            path = LAUNCH_PATH[name]
            src, rep = SOURCES[name]
            line.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                         "launches": self.launches[path][name], "launches_path": path, "shape": row["shape"],
                         "max_abs_err": row["max_abs_err"], "ms": row["ms"], "kernel_ms": row["ms"],
                         "plain_ms": row["plain_ms"],
                         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                         "library_ms": row["library_ms"], "wall_ms": row["wall_ms"]})
        emit({"kernels": line})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU", file=sys.stderr)
        return 2
    smoke = Smoke()
    for phase in (smoke.build, smoke.knn2, smoke.scan, smoke.frontend, smoke.tick, smoke.profile,
                  smoke.reduce_vec, smoke.kinfu, smoke.profile_kinfu, smoke.pyrdown_remap, smoke.dense_flow):
        phase()
    smoke.kernels_line()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": smoke.name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
