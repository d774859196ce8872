#!/usr/bin/env python3
"""Smoke run of the PyTorch port (opencv_contrib_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

It builds the hand-written kernels from opencv_contrib_tpu_torch/ops/cuda/csrc
(first use, a few seconds of nvcc), holds each kernel against its plain
PyTorch version on the card, drives the port's main paths through the entry
points (`entry.frontend`, `entry.keyframe_tick`, `entry.kinfu_track`,
`entry.dense_flow`, `entry.photometric`, the two SfM drivers), and checks
their outputs.

Phases, one JSON line each:
  (a) build and launch checks at small ragged shapes;
  (b) knn2 against its plain version at 8192x8192x128 (the matcher bench),
      1000x3000x64 (ragged) and 512x512x64 (the keyframe tick's matches):
      one device launch a call, the same bits on a rerun, for other splits of
      the train set (explicit tile_t, split and unsplit, run in turns many
      times: the ticket is reset), and with the best and second best in
      different spans; timed L2-warm and L2-cold;
  (c) grid_scan at 64x256 (CLAHE's CDFs) and 480x640, integral_image at
      480x640, 2048x2048 and 4000x8000, against their plain versions, and
      both at ragged shapes (grid_scan: W % 4 != 0, W = 1, W > 1,024, one
      row, a view 4 bytes off); `ops.integral.integral` (the padded table)
      one device launch a call, its zero row and column, and its interior
      equal to integral_image bit for bit; a rerun equal; the launch floor
      (the device time of `add_(1)` on one element) beside grid_scan's rows;
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
      1 cm / 0.01 rad offset: one device launch a call, the same bits on
      calls in turns across levels and poses (a ticket left set would show),
      timed L2-warm and L2-cold;
  (h) KinectFusion: the bench tick of bench.py::bench_kinfu_vga512 (VGA,
      512^3, 12288 sparse blocks; ms per tick and peak memory), an 8-frame
      VGA orbit through `entry.kinfu_track` with the counters read around it
      and held to the reference drift gates, the same orbit on the plain
      path, a small orbit on the card against the CPU, and the tick under
      torch.profiler, stage by stage through KinFu.update's
      record_function ranges;
  (i) the pyrdown kernel in both borders at 436x1024, 218x512, 109x256 (odd
      output) and 480x640, one device launch a call, a rerun equal, timed
      beside the launch floor, and at sides of 1 to 3, an odd level and a
      view 4 bytes off; and the remap kernel in both contracts (max_disp 4
      and None) with C = 1 and 3 at 436x1024 and 55x128; each against its
      plain version and timed beside the nearest PyTorch call;
  (j) dense flow: `entry.dense_flow` with DIS and TV-L1 on `entry.flow_pair()`
      (MPI-Sintel's 436x1024) with the counters read around it, the interior
      EPE gates, the plain path, a 96x128 pair on the card against the CPU,
      ms per pair, peak memory, and one profiled pair per method;
  (k) grid_transform (the path's maps, strided channel views included),
      streamed_transform, grid_reduce (sum, min, max), grid_reduce_sums (the
      path's three groups, against the plain version and bit for bit against
      single grid_reduce calls) and grid_histogram (both rules, 8x8 batched
      tiles; one device launch a call, the same bits on calls in turns, and
      ragged shapes on both walks, float4 and scalar, with tiles of one and
      of several blocks, up to 12,288 bins) against their plain versions at
      1080x1920, at the clip's 8640x5760 for the stream, and at ragged
      shapes and unaligned views (both paths of the row walk), each timed
      beside the nearest PyTorch call with L2-warm inputs, and most rows
      also with the L2 flushed before each call (a read of 128 MiB, which
      leaves clean lines);
  (l) the photometric path: `entry.photometric` on `entry.photo_clip()`
      (8 x 1080 x 1920 x 3) with the counters read around it and held to
      the counts its loops give, the restoration gate (the balanced clip
      nearer the clean one than the degraded clip is), the plain path on
      the card, a 2 x 100 x 130 clip on the card against the CPU, ms per
      frame, peak memory and one profiled frame;
  (m) incremental SfM: `sfm.pipeline.reconstruct_incremental` with
      intrinsics refinement on `entry.sfm_scene()` (100 views x 900 tracks,
      noise 0.5 px, lens distortion) with the counters read around it (no
      kernel of ours lies on this path: every count stays 0), held to the
      backyard gate form (>= 90 views, >= 0.9 of the tracks, mean
      reprojection <= 1.4 px); a 16 x 256 scene on the card against the CPU
      with the same RANSAC draws; s a reconstruction, host ms a span,
      host syncs, peak memory and one profiled run; the first differing
      entries of the two logs of the small scene;
  (n) sparse bundle adjustment (ba/sparse.py): 2048 cameras x 200,000
      points x 2,000,000 observations (tests/test_scale_tpu.py's problem), 3
      LM iterations of 10 CG iterations below 1e-2 of the initial cost, the
      same bits on a rerun, device ms an LM iteration, wall ms, launches,
      host syncs and peak memory of a solve, the top device ops; the 64 x
      4096 x 8 problem of tests/test_ba_sparse.py with pixel noise on the
      card against the CPU; and `reconstruct_incremental` on
      `entry.sfm_scene(150, 1000)` (above SPARSE_BA_OBS_THRESHOLD) with
      intrinsics refinement, with a spy on the sparse route, the counters
      read around it and phase m's gate form;
  (o) the 5k-view sequential SfM driver (sfm/pipeline_scale.py):
      `reconstruct_sequential` on `entry.sfm_sequence_scene()` at 1,024
      slots, 0.3 px noise, with scripts/sfm_scale_run.py's settings, cut
      from 5,000 views to 2,500 for time, once, with the counters read
      around it (every count stays 0), held to >= 0.9 of the views, a mean
      reprojection <= 1.4 px, points on >= 0.6 of the tracks and an ATE
      under 0.3 on every 96-view window of the dominant segment; wall s,
      keyframes/s, host ms a span, host syncs, peak memory; the 256 x 1,024
      run of tests/test_scale_tpu.py profiled by step (chunk, windowed BA,
      re-triangulation, global bundle: launches, device ms and syncs each,
      busy share, top device ops); and a noise-free 48 x 48 orbit on the card
      against the CPU with the same RANSAC draws.
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
    "grid_transform": ("opencv_contrib_tpu_torch/ops/cuda/csrc/transform.cu",
                       "opencv_contrib_tpu/ops/pallas/grid.py:54"),
    "streamed_transform": ("opencv_contrib_tpu_torch/ops/cuda/csrc/transform.cu",
                           "opencv_contrib_tpu/ops/pallas/pipeline.py:143"),
    "grid_reduce": ("opencv_contrib_tpu_torch/ops/cuda/csrc/reduce.cu", "opencv_contrib_tpu/ops/pallas/grid.py:91"),
    "grid_histogram": ("opencv_contrib_tpu_torch/ops/cuda/csrc/histogram.cu",
                       "opencv_contrib_tpu/ops/pallas/grid.py:205"),
}
# the kernels each main path runs; a kernel's launches are reported from the
# last path that runs it
PATH_KERNELS = {"frontend": ("knn2", "integral_image"),
                "keyframe_tick": ("knn2", "integral_image"), "kinfu_tick": ("grid_reduce_vec",),
                "dense_flow": ("pyrdown", "remap"),
                "photometric": ("grid_transform", "streamed_transform", "grid_reduce", "grid_histogram", "grid_scan"),
                "sfm": (), "sfm_sparse": (), "sfm_scale": ()}
LAUNCH_PATH = {k: path for path, ks in PATH_KERNELS.items() for k in ks}
DEVICE_KERNELS = ("knn2_kernel", "scan_rows_kernel", "integral_kernel", "grid_reduce_vec_kernel", "pyrdown_kernel",
                  "remap_kernel", "grid_transform_vec4_kernel", "grid_transform_strided_kernel",
                  "streamed_transform_kernel", "grid_reduce_vec4_kernel", "grid_reduce_strided_kernel",
                  "grid_histogram_kernel")
TRANSFORM_KERNELS = ("grid_transform_vec4_kernel", "grid_transform_strided_kernel")
REDUCE_KERNELS = ("grid_reduce_vec4_kernel", "grid_reduce_strided_kernel")
# a read of this many bytes (torch.amax of an int16 buffer) before each
# L2-cold call evicts the 50 MB L2 and leaves it holding clean lines: a write
# would leave dirty lines whose write-back the timed call would pay. Its
# kernels, found by profiling it alone, are left out of every device time.
L2_FLUSH_BYTES = 128 << 20
# the kernel of a uint8 Tensor.zero_: the markers that open each profiler
# window (a new trace drops its first few kernel events); no timed call
# launches it, and it is left out of every device time
FLUSH_KERNEL = "FillFunctor<unsigned char>"
N_MARKERS = 8
# device_ms: a trace drops the first kernel events of its window, and now and
# then all of them; a window waits WINDOW_PAD_S before its markers and after
# its last kernel, four times longer each time it is taken again, at most
# N_WINDOWS times a call
WINDOW_PAD_S = 0.01
N_WINDOWS = 5
PYRDOWN_SHAPES = [(436, 1024), (218, 512), (109, 256), (480, 640)]  # the Sintel pyramid's levels 0-2, and VGA
# sides of 1 to 3 (the taps reach past the image: the reflect border folds
# again), an odd level (odd in and out), and (436, 1024) as a view 4 bytes
# off (the staging's element-by-element loads)
PYRDOWN_RAGGED = [(1, 1), (1, 6), (2, 6), (3, 4), (2, 2), (3, 3), (6, 1), (37, 21)]
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
PHOTO_CLIP = (8, 1080, 1920)  # entry.photo_clip()'s defaults: T, H, W
PHOTO_SMALL = (2, 100, 130)  # tests/test_torch_photometric.py's clip: its CLAHE tiles crop the frame
# launches per frame on entry.photometric: grid_transform 3 (grayworld gains)
# + 2 (gray of the output and of the clean frame) + 1 (SSIM map) + 1 (GMS
# map) + 2 x 5 (BRISQUE: MSCN and 4 products a scale) + 1 (the score's
# MSCN); grid_reduce 1 (grayworld's group) + 1 (MSE) + 1 (SSIM) + 2 (GMSD)
# + 2 x 5 (BRISQUE: the GGD group and 4 AGGD groups a scale) + 1 (the
# score's GGD group); grid_histogram 1 (CLAHE's tiles); grid_scan 1 (CLAHE's
# tile CDFs); streamed_transform 1 a clip (the gamma)
PHOTO_PER_FRAME = {"grid_transform": 18, "grid_reduce": 16, "grid_histogram": 1, "grid_scan": 1}
N_PHOTO_TIMED = 3
ALPHA_FEATURES = [0, 2, 6, 10, 14, 18, 20, 24, 28, 32]  # BRISQUE's shape parameters, points of a 0.01 grid
ALPHA_STEP = 0.01 + 1e-6
ULP2 = 2.0 ** -22  # two float32 ulp, relative
KNN2_SHAPES = [(8192, 8192, 128), (1000, 3000, 64), (512, 512, 64)]
# explicit tile_t that split the train set otherwise than the wrapper's plan
# (tests/test_torch_kernels.py holds the plans), one of them unsplit
KNN2_SPLITS = {(1000, 3000, 64): (1024, 3000), (512, 512, 64): (128, 512)}
N_KNN2_TURNS = 12  # split and unsplit calls in turns, each against the first bits
# integral_image: the frontend's VGA frame, a square image of three slabs
# across, and a tall and wide one of 17 slabs across; grid_scan: CLAHE's 64
# tile CDFs of 256 bins (its main path) and a VGA frame
SCAN_SHAPES = [(480, 640), (2048, 2048), (4000, 8000)]
GRID_SCAN_SHAPES = [(64, 256), (480, 640)]
# W % 4 != 0 (a float a lane's loads), W = 1, W > 1,024 (passes of 1,024
# with a carry, float4 and float loads), one row; and CLAHE's 64x256 as a
# view 4 bytes off
GRID_SCAN_RAGGED = [(64, 255), (37, 1), (5, 1025), (100, 2048), (1, 3001), (1, 640)]
# W % 4 != 0 (the scalar path), one row, fewer rows than a band, short and
# wide (bands of 8 rows, 8 slabs across), 48 bands of 105 rows (47 earlier
# bands' totals in three groups), and three slabs across with W % 4 != 0
SCAN_RAGGED = [(481, 643), (1, 7), (37, 5), (40, 8000), (5000, 64), (1000, 3001)]
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
N_GETAB_TURNS = 4  # getAb at each level and pose in turns, each against its first bits
# grid_histogram: calls in turns (CLAHE's tiles, the frame in both rules),
# each against its first bits; and ragged cases, each in both rules at every
# (bins, vmin, vmax) below: up to the wrapper's 12,288 bins, a clamp range
# of 1 and 2 (powers of two) and of 1.5 (not), each against the plain
# version on the card and on the CPU
N_HIST_TURNS = 4
HIST_RAGGED_SHAPES = [((101, 257), None), ((101, 257), (2, 1)), ((5, 3), None), ((5, 3), (2, 1)),
                      ((257, 1024), (2, 4)), ((130, 1030), (2, 2)), ((1, 100000), None), ((1, 100003), None),
                      ((1, 1000003), None), ((64, 256), (8, 8))]
HIST_RAGGED_BINS = [(10, 0.0, 1.0), (256, 0.0, 2.0), (1000, -0.25, 1.25), (12288, 0.0, 1.0)]
STAGE_PREFIX = "kinfu."  # KinFu.update's record_function ranges
SFM_PREFIX = "sfm."  # the SfM driver's spans (utils/tracing.trace_span)
SFM_SPANS = {"init_two_view", "intersect", "bundle", "resect", "final_bundle"}
# phase m: entry.sfm_scene()'s 100 views x 900 tracks (89,999 markers, under
# the sparse-BA threshold), with intrinsics refinement, held to the gate form
# of the reference's backyard pipeline test (tests/test_sfm_reference_data.py:
# at least 90 of 100 views, a mean reprojection of at most 1.4 px) and at
# least 0.9 of the tracks reconstructed
SFM_MIN_VIEWS, SFM_MIN_POINT_SHARE, SFM_MEAN_PX_GATE = 90, 0.9, 1.4
SFM_SMALL = (16, 256)  # views x tracks of the card-against-CPU scene
N_SFM_TIMED = 2
# card against CPU on SFM_SMALL with the same draws: the registered views
# equal, the reconstructed tracks within max(2, 1%), rms and mean px within
# 1e-3 px, the points within 1e-3 (a scene about 2 units across) RMS after a
# similarity alignment, the focal length within rtol 1e-3, k1 and k2 within
# 2e-3 and the principal point within 1 px (it lies in a valley of the cost
# that a half ring of cameras at one height leaves flat; tests/
# test_torch_sfm.py::test_reconstruct_incremental_replayed holds the port to
# the JAX package by the same rule)
SFM_CPU_TOL = {"points": 0.01, "rms_px": 1e-3, "aligned_points": 1e-3, "focal_rtol": 1e-3, "pp_px": 1.0,
               "k12": 2e-3}
# phase n: the sparse BA (ba/sparse.py) at the shape of tests/test_scale_tpu.py::
# test_sparse_ba_two_million_obs (cameras, points, observations from default_rng(0); 3 LM iterations of 10 CG
# iterations; gate: the final cost under 1e-2 of the initial), run twice for the same bits
SPARSE_BIG = (2048, 200_000, 2_000_000)
SPARSE_BIG_ITERS, SPARSE_BIG_CG, SPARSE_BIG_GATE = 3, 10, 1e-2
N_SPARSE_TIMED = 3
# card against CPU on tests/test_ba_sparse.py::test_sparse_moderate_scale_cpu's problem (64 cameras x 4096
# points x 8 observations, 8 LM iterations of 20 CG iterations) with N(0, 0.5 px) pixel noise added, so the
# optimum's cost is far above float32 rounding (without it both end at ~5e-6 from 7.4e4, where a relative
# comparison means nothing): final costs within rtol 1e-3, cameras and points within 1e-5 (measured on an H100:
# at most 9.5e-7 and 3.6e-7)
SPARSE_SMALL = (64, 4096, 8)
SPARSE_SMALL_ITERS, SPARSE_SMALL_CG, SPARSE_SMALL_NOISE_PX = 8, 20, 0.5
SPARSE_CPU_TOL = {"cost_rtol": 1e-3, "params": 1e-5}
# the dense driver above SPARSE_BA_OBS_THRESHOLD: entry.sfm_scene(150, 1000) with intrinsics refinement (the
# fixpoint's bundles and the final bundle sparse, the intrinsics bundles dense), phase m's gate form
SFM_SPARSE = (150, 1000)
SFM_SPARSE_MIN_VIEW_SHARE = 0.9
# phase o: the 5k-view sequential driver (sfm/pipeline_scale.py) on entry.sfm_sequence_scene(): scripts/
# sfm_scale_run.py's configuration is 5,000 views x 1,024 slots with its settings; the script runs it cut to 2,500
# views (slots, noise and settings uncut; by that script's rule tracks live max(24, V // 125) = 24 views and min_gap is
# max(3, 24 // 3) = 8): the 5,000 took 546.5 s on the card's host, which would put the script past half its 1,200 s
# limit (PERF.md §4). Gates: tests/test_sfm_scale.py's (>= 0.9 of the views, points on >= 0.6 of the tracks), the
# reference's 1.4 px mean reprojection (test_simple_pipeline.cpp:82), and tests/test_sfm_scale.py:57-60's ATE < 0.3
# (similarity-aligned camera centres, ring radius 4) at that test's own scale: on every 96-view window of the dominant
# segment. Over the whole segment the reference drifts past it: the JAX package's dominant segment at 2,500 views
# has an ATE of 2.485 (scripts/sfm_scale_ate.py; ROADMAP Queue 3), so that ATE is reported, not gated
SFM_SCALE = (2500, 1024)
SFM_SCALE_RUN = dict(window=24, ba_every=4, min_gap=max(3, max(24, SFM_SCALE[0] // 125) // 3), min_parallax_deg=0.4,
                     final_global_iters=15)
SFM_SCALE_MIN_VIEW_SHARE, SFM_SCALE_MIN_POINT_SHARE, SFM_SCALE_ATE, SFM_SCALE_ATE_WINDOW = 0.9, 0.6, 0.3, 96
# the profiled run: tests/test_scale_tpu.py::test_sfm_scale_256_end_to_end (256 x 1,024, span 24; >= 250 views)
SFM_SCALE_PROFILED = (256, 1024)
SFM_SCALE_PROFILED_RUN = dict(window=24, ba_every=4, min_gap=3, final_global_iters=15)
SFM_SCALE_PROFILED_MIN_VIEWS = 250
SFM_SCALE_PROFILED_WINDOW = (36, 44)  # the profiled chunks (views 145-176; a growth-triggered global bundle at 158)
# card against CPU with the same draws on a noise-free 48 x 48 orbit (tests/test_torch_sfm_scale.py's settings; on
# noisy pixels f32 rounding, amplified by near-parallel triangulation, decides points at the 4 px gate where the
# ring closes, so two correct runs part there: ROADMAP Queue 3): the same registered views and reg_order, mean
# reprojection within 1e-3 px, points within 1e-3 RMS after a similarity alignment
SFM_SCALE_SMALL = dict(n_views=48, slots_per_view=48, track_span=10, seed=1, noise_px=0.0)
SFM_SCALE_SMALL_RUN = dict(window=12, ba_every=3, min_gap=2)
SFM_SCALE_CPU_TOL = {"mean_px": 1e-3, "aligned_points": 1e-3}
SCALE_PREFIX = "sfm_scale."  # the 5k driver's spans (its own: sequential, global_ba)
# the script's spans around the driver's device steps (module functions the driver looks up at each call)
SCALE_STEPS = {"_chunk_register_jit": "chunk", "_windowed_ba_jit": "windowed_ba", "_retriangulate": "retriangulate",
               "_global_ba_jit": "global_bundle"}


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


def log_diff(a: list, b: list, n: int = 3) -> dict | None:
    """The first entries where two reconstruction logs part (None if equal)."""
    if a == b:
        return None
    i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return {"index": i, "lengths": [len(a), len(b)], "a": [list(e) for e in a[i:i + n]],
            "b": [list(e) for e in b[i:i + n]]}


def similarity_rms(A: np.ndarray, B: np.ndarray) -> float:
    """Residual RMS of the best similarity transform A -> B (Umeyama)."""
    muA, muB = A.mean(0), B.mean(0)
    Ac, Bc = A - muA, B - muB
    U, S, Vt = np.linalg.svd(Ac.T @ Bc / len(A))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((Ac ** 2).sum() / len(A))
    return float(np.sqrt((((A - muA) * s @ R + muB - B) ** 2).sum(axis=1).mean()))


def two_million_problem(dev):
    """tests/test_scale_tpu.py::test_sparse_ba_two_million_obs's problem on
    `dev` (SPARSE_BIG from default_rng(0), pixels from the port's forward
    model, points with N(0, 0.01) noise) and its camera buckets."""
    import torch

    from opencv_contrib_tpu_torch.ba import sparse

    rng = np.random.default_rng(0)
    C, P, N = SPARSE_BIG
    ts = np.stack([np.linspace(-0.1, 0.1, C), np.zeros(C), np.full(C, 4.0)], axis=1).astype(np.float32)
    pts = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    intr = np.array([600, 600, 320, 240, 0, 0, 0, 0, 0], np.float32)
    cams6 = np.concatenate([np.zeros((C, 3), np.float32), ts], axis=1)
    obs_cam = rng.integers(0, C, N).astype(np.int32)
    obs_pt = rng.integers(0, P, N).astype(np.int32)
    noisy = pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    card = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    oc, op = card(obs_cam), card(obs_pt)
    uv = sparse._project_cf(card(cams6).T[:, oc], card(pts).T[:, op], card(intr))
    prob = sparse.SparseBAProblem(card(cams6), card(noisy), card(intr), oc, op, uv,
                                  torch.ones(N, dtype=torch.bool, device=dev))
    return prob, sparse.build_buckets(obs_cam, obs_pt, np.ones(N, bool), C, P, device=dev)


@contextlib.contextmanager
def plain_path():
    """The port's path with each kernel call site switched to the plain
    version, on the same CUDA tensors. The library never makes that choice
    for a CUDA tensor, so this check makes it here, at the call sites."""
    from opencv_contrib_tpu_torch.features import match
    from opencv_contrib_tpu_torch.ops import integral
    from opencv_contrib_tpu_torch.ops.cuda import histogram, matching, pyramid, reduce, remap, scan, transform

    def knn2(q, t, tile_q=512, tile_t=None):
        return matching.knn2_plain(q, t, tile_q)

    def grid_transform(m, *arrays, out=None):
        res = transform.grid_transform_plain(m.fn, *arrays)
        return res if out is None else out.copy_(res)

    def grid_reduce(m, *arrays, kind="sum", div=1.0):
        return reduce.grid_reduce_plain(m.fn, *arrays, kind=kind) / div

    def grid_reduce_sums(group, *arrays, div=1.0, kind="sum"):
        return reduce.grid_reduce_sums_plain(group, *arrays, div=div)

    with mock.patch.object(integral, "integral_padded", scan.integral_padded_plain), \
            mock.patch.object(scan, "grid_scan", scan.grid_scan_plain), \
            mock.patch.object(match, "use_kernel", lambda x: False), \
            mock.patch.object(matching, "knn2", knn2), \
            mock.patch.object(reduce, "icp_getab", reduce.icp_getab_plain), \
            mock.patch.object(pyramid, "pyrdown", pyramid.pyrdown_plain), \
            mock.patch.object(remap, "remap", remap.remap_plain), \
            mock.patch.object(transform, "grid_transform", grid_transform), \
            mock.patch.object(transform, "streamed_transform", lambda m, x: transform.streamed_transform_plain(m.fn, x)), \
            mock.patch.object(reduce, "grid_reduce", grid_reduce), \
            mock.patch.object(reduce, "grid_reduce_sums", grid_reduce_sums), \
            mock.patch.object(histogram, "grid_histogram", histogram.grid_histogram_plain):
        yield


class Timer:
    """Device times of calls on one card, from torch.profiler."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.marker = self.l2_flush = None  # the window markers and the L2 flush buffer
        self.flush_keys = frozenset()  # the flush's kernels

    def flush_l2(self):
        self.torch.amax(self.l2_flush)

    def _flush_setup(self):
        """The flush buffer, and the names of the kernels its read runs (from
        a window of flushes alone), which every device time leaves out."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        self.l2_flush = torch.zeros(L2_FLUSH_BYTES // 2, dtype=torch.int16, device=self.dev)
        self.flush_l2()
        torch.cuda.synchronize()
        for _ in range(N_WINDOWS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(WINDOW_PAD_S)
                for _ in range(N_MARKERS):
                    self.marker.zero_()
                for _ in range(4):
                    self.flush_l2()
                torch.cuda.synchronize()
                time.sleep(WINDOW_PAD_S)
            keys = {e.key for e in kernel_events(prof) if FLUSH_KERNEL not in e.key}
            if keys:
                self.flush_keys = frozenset(keys)
                return
        raise AssertionError("torch.profiler recorded none of the L2 flush's kernels")

    def device_events(self, fn, iters: int = 10, cold: bool = False):
        """The kernel events of `iters` calls of fn in one profiler window,
        the markers and the flush left out. cold: the L2 is flushed before
        each call by a read of L2_FLUSH_BYTES. A trace drops the first
        kernel events of its window, so each window opens with a wait and
        N_MARKERS small uint8 fills; a window where none of them survived is
        taken again with a longer wait."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        if self.marker is None:
            self.marker = torch.empty(16, dtype=torch.uint8, device=self.dev)
        if cold and self.l2_flush is None:
            self._flush_setup()
        fn()
        torch.cuda.synchronize()
        pad, seen = WINDOW_PAD_S, []
        for _ in range(N_WINDOWS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                for _ in range(N_MARKERS):
                    self.marker.zero_()
                for _ in range(iters):
                    if cold:
                        self.flush_l2()
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad)
            ev = kernel_events(prof)
            fills = sum(e.count for e in ev if FLUSH_KERNEL in e.key)
            ev = [e for e in ev if FLUSH_KERNEL not in e.key and e.key not in self.flush_keys]
            us = sum(e.self_device_time_total for e in ev)
            seen.append({"pad_s": pad, "fills": fills, "us": us})
            pad *= 4
            if fills > 0 and us > 0:
                return ev
        raise AssertionError(f"torch.profiler recorded no device time, or not every call's: {seen}")

    def device_ms(self, fn, iters: int = 10, names=None, cold: bool = False):
        """Device time of one call: the durations of the kernels it ran, from
        torch.profiler, without the host time between them; with `names`,
        (that time, the time of those of DEVICE_KERNELS alone), both from
        one profiler window."""
        ev = self.device_events(fn, iters, cold)
        us = sum(e.self_device_time_total for e in ev)
        if names is None:
            return us / iters / 1e3
        ours = sum(e.self_device_time_total for e in ev if any(is_ours(e.key, k) for k in names))
        return us / iters / 1e3, ours / iters / 1e3

    def launches_per_call(self, fn, iters: int = 10) -> dict:
        """Device launches of one call: all of its kernels, and by name those
        of DEVICE_KERNELS."""
        ev = self.device_events(fn, iters)
        out = {"all": sum(e.count for e in ev) / iters}
        for k in DEVICE_KERNELS:
            n = sum(e.count for e in ev if is_ours(e.key, k))
            if n:
                out[k] = n / iters
        return out

    def launch_floor_ms(self) -> float:
        """The device time of the smallest launch PyTorch makes, `add_(1)` on
        a one-element tensor, over 30 calls: a kernel's call within about
        0.3 us of it is at the floor that no design moves."""
        one = self.torch.zeros(1, device=self.dev)
        return self.device_ms(lambda: one.add_(1), iters=30)

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


class Smoke(Timer):
    def __init__(self):
        import torch

        from opencv_contrib_tpu_torch import entry
        from opencv_contrib_tpu_torch.ops import cuda as kern

        super().__init__(torch, torch.device("cuda", 0))
        self.entry, self.kern = entry, kern
        self.name = torch.cuda.get_device_name(0)
        self.bw, self.flops = next((v for k, v in CARD_PEAKS.items() if k in self.name), CARD_PEAKS["H100"])
        self.gen = np.random.default_rng(0)
        self.frames = entry.make_frames(n_frames=N_FRAMES, H=480, W=640, seed=0)
        self.intr = np.asarray([500.0, 500.0, 320.0, 240.0, 0, 0, 0, 0, 0], np.float32)
        self.kernels = {}  # name -> timing row at the main path's shape
        self.launches = {}  # path -> launch counts

    def card(self, a):
        return self.torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.dev)

    def times(self, fns: dict, names=None, cold: bool = False) -> dict:
        """`ms` (device) and `wall_ms` (events) of the kernel, its plain
        version and the library call, keyed by prefix; with `names`, also
        `kernel_ms`, the device time of those kernels alone in the kernel's
        call (the same window as its `ms`, over 30 calls); with `cold`, also
        `cold_ms` for every call but the plain version: the device time with
        the L2 flushed before each of 30 calls."""
        out = {}
        for prefix, fn in fns.items():
            if names is not None and prefix == "":
                out["ms"], out["kernel_ms"] = self.device_ms(fn, iters=30, names=names)
            else:
                out[prefix + "ms"] = self.device_ms(fn)
            if cold and prefix != "plain_":
                out[prefix + "cold_ms"] = self.device_ms(fn, iters=30, cold=True)
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
    def one_launch(self, fn, what: str, kname: str) -> dict:
        """fn makes one device launch a call, and it is kname's."""
        n = self.launches_per_call(fn)
        check(n["all"] == 1 and n.get(kname) == 1, f"{what}: device launches per call {n}")
        return n

    def knn2(self):
        from opencv_contrib_tpu_torch.ops.cuda import matching as fused
        from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

        torch = self.torch
        same = lambda a, b: bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))  # noqa: E731
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        rows, splits = [], []
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
                check(same(fused.knn2(q, t), (d, i)), f"knn2 {Q}x{Tn}x{D}: a rerun changed the bits")
                n = self.one_launch(lambda: fused.knn2(q, t), f"knn2 {Q}x{Tn}x{D}", "knn2_kernel")
                for tile_t in KNN2_SPLITS.get((Q, Tn, D), ()):
                    check(fused.plan(Q, Tn, sms, tile_t)[2] != fused.plan(Q, Tn, sms)[2], "knn2: same split")
                    for turn in range(N_KNN2_TURNS):  # split and unsplit in turns: each resets its tickets
                        check(same(fused.knn2(q, t, tile_t=None if turn % 2 else tile_t), (d, i)),
                              f"knn2 {Q}x{Tn}x{D}: tile_t {tile_t} (turn {turn}) changed the bits")
                    splits.append({"shape": [Q, Tn, D], "plan": fused.plan(Q, Tn, sms),
                                   "tile_t": tile_t, "other_plan": fused.plan(Q, Tn, sms, tile_t), "same_bits": True})
                fns = {"": lambda: fused.knn2(q, t), "plain_": lambda: fused.knn2_plain(q, t),
                       "library_": lambda: torch.topk(torch.cdist(q, t), 2, dim=1, largest=False)}
                times = self.times(fns, cold=True)
            nbytes, ops = 4 * (Q * D + Tn * D + 3 * Q), 2 * Q * Tn * D
            rows.append({"shape": [Q, Tn, D], "plan": fused.plan(Q, Tn, sms), "max_abs_err": err,
                         "err_over_tol": worst, "idx_agree": agree, "launches_per_call": n, **times,
                         "bound_ms": max(nbytes / self.bw, ops / self.flops) * 1e3,
                         "bound_by": "operations" if ops / self.flops > nbytes / self.bw else "bytes",
                         "pairs_per_s": Q * Tn / (times["ms"] * 1e-3)})
        # best and second best in different spans: each query's two nearest
        # train rows are 512 rows apart, more than a span
        q = self.card(self.gen.normal(size=(512, 64)))
        t = torch.cat([q + 0.01, q + 0.02, self.card(self.gen.normal(size=(512, 64)))])
        with f32_matmul_precision():
            d, i = fused.knn2(q, t)
            dp, ip = fused.knn2_plain(q, t)
        span = fused.plan(512, 1536, sms)[1]
        check(span <= 256 and bool((i == torch.arange(512, device=self.dev, dtype=torch.int32)).all())
              and torch.allclose(d, dp, rtol=1e-5, atol=1e-4) and same(fused.knn2(q, t, tile_t=1536), (d, i)),
              f"knn2: best and second best in spans {span} rows long")
        cross = {"shape": [512, 1536, 64], "span": span, "second_minus_best_max": float((d[:, 1] - d[:, 0]).max()),
                 "max_abs_err": float((d - dp).abs().max())}
        self.kernels["knn2"] = rows[0]
        emit({"phase": "b_knn2", "tolerance": "rtol 1e-5, atol 1e-4; idx agreement >= 0.999; equal bits on a "
                                               "rerun and for other splits",
              "timing": "ms: device time per call (torch.profiler); cold_ms: the same with a 128 MiB read before "
                        "each call (its kernels left out); wall_ms: CUDA events per call",
              "library_call": "torch.topk(torch.cdist(q, t), 2, largest=False)", "sms": sms, "runs": rows,
              "splits": splits, "cross_span": cross, "ok": True})

    # ---- (c) -----------------------------------------------------------------
    def scan(self):
        import torch.nn.functional as F

        from opencv_contrib_tpu_torch.ops import integral
        from opencv_contrib_tpu_torch.ops.cuda import scan

        torch = self.torch
        rows = []
        floor = self.launch_floor_ms()

        def held(kname, fn, plain, library, dev_name, H, W):
            x = self.card(self.gen.uniform(0, 255, size=(H, W)))
            out, ref = fn(x), plain(x)
            torch.cuda.synchronize()
            err, top = float((out - ref).abs().max()), float(ref.abs().max())
            check(err <= 2e-6 * top, f"{kname} {H}x{W}: max err {err} > 2e-6 * {top}")
            check(torch.equal(fn(x), out), f"{kname} {H}x{W}: a rerun changed the bits")
            n = self.one_launch(lambda: fn(x), f"{kname} {H}x{W}", dev_name)
            row = {"kernel": kname, "shape": [H, W], "max_abs_err": err, "max_abs": top, "launches_per_call": n,
                   **self.times({"": lambda: fn(x), "plain_": lambda: plain(x), "library_": lambda: library(x)},
                                cold=True),
                   "bound_ms": 2 * 4 * H * W / self.bw * 1e3, "bound_by": "bytes"}
            rows.append(row)
            return x, row

        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        for H, W in GRID_SCAN_SHAPES:
            _, row = held("grid_scan", scan.grid_scan, scan.grid_scan_plain, lambda a: torch.cumsum(a, 1),
                          "scan_rows_kernel", H, W)
            row.update(plan=scan.scan_plan(H, W, sms), launch_floor_ms=floor)
            if (H, W) == GRID_SCAN_SHAPES[0]:
                self.kernels["grid_scan"] = row
        scan_ragged = []
        views = [(shape, False) for shape in GRID_SCAN_RAGGED] + [(GRID_SCAN_SHAPES[0], True)]
        gen = np.random.default_rng(1)  # the later phases keep self.gen's draws
        for (H, W), off in views:
            x = self.card(gen.uniform(0, 255, size=H * W + off))[int(off):].view(H, W)
            out, ref = scan.grid_scan(x), scan.grid_scan_plain(x)
            torch.cuda.synchronize()
            err, top = float((out - ref).abs().max()), float(ref.abs().max())
            check(err <= 2e-6 * top and torch.equal(scan.grid_scan(x), out),
                  f"grid_scan ragged {H}x{W} (4 bytes off: {off}): max err {err}, a rerun equal")
            n = self.one_launch(lambda: scan.grid_scan(x), f"grid_scan ragged {H}x{W}", "scan_rows_kernel")
            scan_ragged.append({"shape": [H, W], "four_bytes_off": off, "plan": scan.scan_plan(H, W, sms),
                                "max_abs_err": err, "max_abs": top, "launches_per_call": n,
                                "ms": self.device_ms(lambda: scan.grid_scan(x), iters=30)})
        for H, W in SCAN_SHAPES:
            x, row = held("integral_image", scan.integral_image, scan.integral_image_plain,
                          lambda a: torch.cumsum(torch.cumsum(a, 0), 1), "integral_kernel", H, W)
            row["slabs"] = scan.slabs(H, W)
            if (H, W) == SCAN_SHAPES[0]:
                self.kernels["integral_image"] = row
            # the padded table of ops.integral.integral, in the same launch
            ii = integral.integral(x)
            top = float(ii.abs().max())
            err = float((ii - F.pad(scan.integral_image_plain(x), (1, 0, 1, 0))).abs().max())
            check(tuple(ii.shape) == (H + 1, W + 1) and err <= 2e-6 * top and not bool(ii[0].any())
                  and not bool(ii[:, 0].any()) and torch.equal(ii[1:, 1:], scan.integral_image(x))
                  and torch.equal(integral.integral(x), ii), f"integral {H}x{W}: max err {err}")
            n = self.one_launch(lambda: integral.integral(x), f"integral {H}x{W}", "integral_kernel")
            rows.append({"kernel": "integral (padded)", "shape": [H, W], "max_abs_err": err, "max_abs": top,
                         "launches_per_call": n, "ms": self.device_ms(lambda: integral.integral(x), iters=30),
                         "cold_ms": self.device_ms(lambda: integral.integral(x), iters=30, cold=True),
                         "bound_ms": 4 * (H * W + (H + 1) * (W + 1)) / self.bw * 1e3, "bound_by": "bytes"})
        ragged = []
        for H, W in SCAN_RAGGED:
            x = self.card(self.gen.uniform(0, 255, size=(H, W)))
            out, ref = scan.integral_image(x), scan.integral_image_plain(x)
            ii = integral.integral(x)
            torch.cuda.synchronize()
            err, top = float((out - ref).abs().max()), float(ref.abs().max())
            check(err <= 2e-6 * top and torch.equal(ii[1:, 1:], out) and not bool(ii[0].any())
                  and not bool(ii[:, 0].any()), f"integral_image ragged {H}x{W}: max err {err}")
            ragged.append({"shape": [H, W], "slabs": scan.slabs(H, W), "max_abs_err": err, "max_abs": top})
        emit({"phase": "c_scan", "tolerance": "max abs err <= 2e-6 * max|out|; equal bits on a rerun; the padded "
                                               "table's interior equal to integral_image",
              "timing": "ms: device time per call (torch.profiler); cold_ms: the same with a 128 MiB read before "
                        "each call (its kernels left out); wall_ms: CUDA events per call",
              "library_call": "torch.cumsum (twice for integral_image)", "launch_floor_ms": floor, "runs": rows,
              "ragged": ragged, "grid_scan_ragged": scan_ragged, "ok": True})

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
        rows, calls = [], []
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
                calls.append((f"level {lvl} {label}", args, torch.cat([A.reshape(-1), b, n[None], err[None]])))
                launches = self.one_launch(lambda: reduce.icp_getab(*args), f"getAb level {lvl} {label}",
                                           "grid_reduce_vec_kernel")
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
                row = {"level": lvl, "T": label, "shape": [H, W], "blocks": reduce.getab_plan(H, W),
                       "n_corr": float(n), "n_corr_plain": float(n_p), "A_err_over_max": errA, "b_err_over_max": errb,
                       "max_abs_err": max(float((A - Ap).abs().max()), float((b - bp).abs().max())),
                       "launches_per_call": launches,
                       **self.times({"": lambda: reduce.icp_getab(*args), "plain_": lambda: reduce.icp_getab_plain(*args)},
                                    cold=True),
                       "library_ms": None, "bound_ms": max(nbytes / self.bw, ops / self.flops) * 1e3,
                       "bound_by": "operations" if ops / self.flops > nbytes / self.bw else "bytes",
                       "bytes": nbytes, "ops": ops, "work": work}
                rows.append(row)
                if lvl == 0 and label == "offset":
                    self.kernels["grid_reduce_vec"] = row
        # every level and pose in turns, so each call follows one at another
        # block count: a ticket left set would change the bits
        for turn in range(N_GETAB_TURNS):
            for what, args, first in calls:
                A, b, n, err = reduce.icp_getab(*args)
                check(torch.equal(torch.cat([A.reshape(-1), b, n[None], err[None]]).view(torch.int32),
                                  first.view(torch.int32)), f"getAb {what}: turn {turn} changed the bits")
        emit({"phase": "g_reduce_vec", "tolerance": "n_corr within max(3, 0.1%); A, b within 1e-4 of max|A|, max|b|; "
                                                     "one device launch a call; equal bits on calls in turns",
              "timing": "ms: device time per call (torch.profiler); cold_ms: the same with a 128 MiB read before "
                        "each call (its kernels left out); wall_ms: CUDA events per call",
              "turns": N_GETAB_TURNS, "library_call": None, "runs": rows, "ok": True})

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
        floor = self.launch_floor_ms()
        pyr_rows, pyr_ragged, remap_rows = [], [], []

        def pyr_held(x, border, what):
            """The kernel against its plain version (<= 1e-6), a rerun equal,
            one device launch a call."""
            Ho, Wo = (x.shape[0] + 1) // 2, (x.shape[1] + 1) // 2
            out, ref = pyramid.pyrdown(x, border), pyramid.pyrdown_plain(x, border)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            check(tuple(out.shape) == (Ho, Wo) and err <= 1e-6 and torch.equal(pyramid.pyrdown(x, border), out),
                  f"pyrdown {border} {what}: max err {err}, a rerun equal")
            n = self.one_launch(lambda: pyramid.pyrdown(x, border), f"pyrdown {border} {what}", "pyrdown_kernel")
            return out, ref, err, n

        with f32_matmul_precision():  # cuDNN's convolution in full f32 too
            for H, W in PYRDOWN_SHAPES:
                x = self.card(self.gen.uniform(0, 4, size=(H, W)))
                Ho, Wo = (H + 1) // 2, (W + 1) // 2
                for border in pyramid.BORDERS:
                    out, ref, err, n = pyr_held(x, border, f"{H}x{W}")
                    xp = F.pad(x[None, None], (2, 2, 2, 2), mode="reflect" if border == "reflect101" else "replicate")
                    lib_out = F.conv2d(xp, w2d, stride=2)[0, 0]
                    # bytes: the input read once, the output written once; operations:
                    # 9 for each of the 5 vertical sums and 9 for the horizontal one
                    nbytes, ops = 4 * (H * W + Ho * Wo), 54 * Ho * Wo
                    row = {"border": border, "shape": [H, W], "out_shape": [Ho, Wo],
                           "max_abs_err": err, "launches_per_call": n,
                           "launch_floor_ms": floor, "library_max_abs_diff": float((lib_out - ref).abs().max()),
                           **self.times({"": lambda: pyramid.pyrdown(x, border),
                                         "plain_": lambda: pyramid.pyrdown_plain(x, border),
                                         "library_": lambda: F.conv2d(xp, w2d, stride=2)}),
                           "bound_ms": max(nbytes / self.bw, ops / self.flops) * 1e3,
                           "bound_by": "operations" if ops / self.flops > nbytes / self.bw else "bytes"}
                    pyr_rows.append(row)
                    if (H, W) == PYRDOWN_SHAPES[0] and border == "reflect101":
                        self.kernels["pyrdown"] = row
            views = [(shape, False) for shape in PYRDOWN_RAGGED] + [(PYRDOWN_SHAPES[0], True)]
            gen = np.random.default_rng(1)  # the later phases keep self.gen's draws
            for (H, W), off in views:
                x = self.card(gen.uniform(0, 4, size=H * W + off))[int(off):].view(H, W)
                for border in pyramid.BORDERS:
                    _, _, err, n = pyr_held(x, border, f"{H}x{W} (4 bytes off: {off})")
                    pyr_ragged.append({"border": border, "shape": [H, W], "four_bytes_off": off,
                                       "max_abs_err": err, "launches_per_call": n})
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
                           "version: 0 expected), equal bits on a rerun; remap: <= 1e-5 on maps in [0, 4)",
              "timing": "ms: device time per call (torch.profiler); wall_ms: CUDA events per call",
              "library_call": {"pyrdown": "F.conv2d(reflect- or edge-padded input, 5x5 binomial, stride=2), "
                                          "the pad outside the timed call",
                               "remap": "F.grid_sample(bilinear, padding_mode=border, align_corners=True), the "
                                        "grid and the bounded contract's clip outside the timed call"},
              "launch_floor_ms": floor, "pyrdown": pyr_rows, "pyrdown_ragged": pyr_ragged, "remap": remap_rows,
              "ok": True})

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

    # ---- (k) -----------------------------------------------------------------
    def row(self, kname, shape, err, fns, nbytes, ops, names, cold=False, **extra):
        """A timing row; with `cold`, the bound's share of the L2-cold time
        too (the DRAM bound is a bound on a cold call)."""
        row = {"kernel": kname, "shape": list(shape), "max_abs_err": err, **extra,
               **self.times(fns, names=names, cold=cold),
               "bound_ms": max(nbytes / self.bw, ops / self.flops) * 1e3,
               "bound_by": "operations" if ops / self.flops > nbytes / self.bw else "bytes",
               "bytes": nbytes, "ops": ops}
        if cold:
            row["bound_over_cold_ms"] = row["bound_ms"] / row["cold_ms"]
        return row

    def ulp_check(self, out, ref, what):
        """out within 2 float32 ulp of ref (0 expected: the kernels round as
        their plain versions; powf is held to 2 ulp)."""
        torch = self.torch
        err = float((out - ref).abs().max())
        tol = (ref.abs() * ULP2).clamp(min=1e-37)
        bad = int(((out - ref).abs() > tol).sum()) + int((torch.isnan(out) != torch.isnan(ref)).sum())
        check(bad == 0, f"{what}: {bad} values past 2 ulp (max abs err {err})")
        return err

    def grid_kernels(self):
        from opencv_contrib_tpu_torch.ops.cuda import histogram as kh
        from opencv_contrib_tpu_torch.ops.cuda import reduce as kr
        from opencv_contrib_tpu_torch.ops.cuda import transform as tf

        torch = self.torch
        T, H, W = PHOTO_CLIP
        rgb = self.card(self.gen.uniform(0, 1, size=(H, W, 3)))
        ch = [rgb[..., c] for c in range(3)]
        u = [self.card(self.gen.uniform(0, 1, size=(H, W))) for _ in range(5)]
        nrm = [self.card(self.gen.standard_normal((H, W))) for _ in range(2)]
        var = self.card(self.gen.uniform(0.01, 0.05, size=(H, W)))
        gains = self.card([1.25, 1.0, 0.8])
        h2, w2 = H // 2, W // 2
        # (name, map, inputs, ops an element); the path's maps at its shapes
        cases = [("mul", tf.mul(), nrm, 1),
                 ("gray_strided", tf.gray(), ch, 5),
                 ("gain_strided", tf.gain(gains, 2), [ch[2]], 3),
                 ("ssim", tf.ssim(1e-4, 9e-4), [u[0], u[1], u[0] * u[0] + var, u[1] * u[1] + var, u[0] * u[1]], 22),
                 ("gms_540x960", tf.gms(0.0026), [x[:h2, :w2].contiguous() for x in (nrm[0], nrm[1], u[0], u[1])], 17),
                 ("mscn", tf.mscn(), [u[2], u[0], u[0] * u[0] + var], 7)]
        t_rows = []
        for name, m, xs, ops in cases:
            out, ref = tf.grid_transform(m, *xs), tf.grid_transform_plain(m.fn, *xs)
            torch.cuda.synchronize()
            err = self.ulp_check(out, ref, f"grid_transform {name}")
            n = xs[0].numel()
            t_rows.append(self.row("grid_transform", xs[0].shape, err,
                                   {"": lambda: tf.grid_transform(m, *xs), "plain_": lambda: tf.grid_transform_plain(m.fn, *xs),
                                    "library_": lambda: m.fn(*xs)},
                                   4 * (m.n_in + 1) * n, ops * n, TRANSFORM_KERNELS, cold=True, map=name,
                                   path="vec4" if tf.vec4_path([*xs, out]) else "strided"))
        check([r["path"] for r in t_rows] == ["vec4", "strided", "strided", "vec4", "vec4", "vec4"],
              f"grid_transform paths {[r['path'] for r in t_rows]}")
        # ragged shapes, an output view, and views that take each path: a
        # padded row pitch with W % 4 != 0 (vec4 with a tail), a view that
        # starts 4 bytes in (strided)
        wide = self.card(self.gen.standard_normal((2, 33, 1004)))
        for label, a, b in [(f"{sh}", *(self.card(self.gen.standard_normal(sh)) for _ in range(2)))
                            for sh in ((7, 13), (33, 1000), (1, 4099))] + [
                ("33x1001 of 33x1004 (vec4, tail)", wide[0, :, :1001], wide[1, :, :1001]),
                ("33x1003 from column 1 (unaligned)", wide[0, :, 1:], wide[1, :, 1:])]:
            o = torch.zeros(a.shape[0], a.shape[1], 2, device=self.dev)
            tf.grid_transform(tf.mul(), a, b, out=o[..., 1])
            full = tf.grid_transform(tf.mul(), a, b)
            torch.cuda.synchronize()
            check(bool((o[..., 1] == a * b).all()) and not bool(o[..., 0].any()) and bool((full == a * b).all()),
                  f"grid_transform ragged {label}")
        check(tf.vec4_path([wide[0, :, :1001]]) and not tf.vec4_path([wide[0, :, 1:]]), "ragged views' paths")
        self.kernels["grid_transform"] = t_rows[0]

        # streamed_transform: the gamma over the clip viewed as (T H, W 3), and ragged arrays
        m = tf.gamma(1 / 2.2)
        s_rows = []
        for shape in ((T * H, W * 3), (37, 301), (3, 5)):
            x = torch.rand(shape, device=self.dev) * 1.2 - 0.1
            out, ref = tf.streamed_transform(m, x), tf.streamed_transform_plain(m.fn, x)
            torch.cuda.synchronize()
            err = self.ulp_check(out, ref, f"streamed_transform {shape}")
            if shape[0] == T * H:
                s_rows.append(self.row("streamed_transform", shape, err,
                                       {"": lambda: tf.streamed_transform(m, x),
                                        "plain_": lambda: tf.streamed_transform_plain(m.fn, x),
                                        "library_": lambda: m.fn(x)},
                                       8 * x.numel(), 2 * x.numel(), ("streamed_transform_kernel",)))
            else:
                s_rows.append({"shape": list(shape), "max_abs_err": err})
            del x, out, ref
        self.kernels["streamed_transform"] = s_rows[0]

        # grid_reduce: sum / min / max of the identity, the MSE's sqdiff, a
        # BRISQUE moment, grayworld's gated sum on channel views
        import torch.nn.functional as F

        r_rows = []
        rcases = [("ident", "sum", [u[0]], lambda a: torch.sum(a), 1),
                  ("ident", "min", [nrm[0]], lambda a: torch.amin(a), 1),
                  ("ident", "max", [nrm[0]], lambda a: torch.amax(a), 1),
                  ("sqdiff", "sum", [u[0], u[1]], lambda a, b: F.mse_loss(a, b, reduction="sum"), 3),
                  ("neg_sq", "sum", [nrm[0]], lambda a: torch.sum(torch.clamp(a, max=0.0) ** 2), 3),
                  ("gated", "sum", ch, lambda r, g, b: torch.sum(r * (torch.maximum(torch.maximum(r, g), b) < 0.98)), 5)]
        for name, kind, xs, lib, ops in rcases:
            m = {"ident": tf.ident(), "sqdiff": tf.sqdiff(), "neg_sq": tf.neg_sq(), "gated": tf.gated(0.98, 0)}[name]
            out, ref = kr.grid_reduce(m, *xs, kind=kind), kr.grid_reduce_plain(m.fn, *xs, kind=kind)
            mag = float(kr.grid_reduce_plain(lambda *a: m.fn(*a).abs(), *xs)) if kind == "sum" else 0.0
            torch.cuda.synchronize()
            err = abs(float(out) - float(ref))
            check(err <= 1e-5 * mag if kind == "sum" else err == 0.0, f"grid_reduce {name} {kind}: err {err}, sum|.| {mag}")
            again = kr.grid_reduce(m, *xs, kind=kind)
            check(float(again) == float(out), f"grid_reduce {name} {kind}: a rerun gave other bits")
            n = xs[0].numel()
            r_rows.append(self.row("grid_reduce", xs[0].shape, err,
                                   {"": lambda: kr.grid_reduce(m, *xs, kind=kind),
                                    "plain_": lambda: kr.grid_reduce_plain(m.fn, *xs, kind=kind),
                                    "library_": lambda: lib(*xs)},
                                   4 * m.n_in * n + 4, ops * n, REDUCE_KERNELS, cold=True,
                                   map=name, kind=kind, sum_abs=mag, path="vec4" if tf.vec4_path(xs) else "strided"))
        wide = self.card(self.gen.standard_normal((33, 1004)))
        ragged = [(str(sh), self.card(self.gen.standard_normal(sh))) for sh in ((1, 1), (7, 13), (33, 1000), (1000, 33))]
        for label, a in ragged + [("33x1001 of 33x1004 (vec4, tail)", wide[:, :1001]),
                                  ("33x1003 from column 1 (unaligned)", wide[:, 1:])]:
            for kind in ("sum", "min", "max"):  # threads past the extent stay neutral
                o, rf = kr.grid_reduce(tf.ident(), a, kind=kind), kr.grid_reduce_plain(lambda v: v, a, kind=kind)
                tol = 1e-5 * float(a.abs().sum()) if kind == "sum" else 0.0
                check(abs(float(o) - float(rf)) <= tol, f"grid_reduce ragged {label} {kind}: {float(o)} vs {float(rf)}")
        self.kernels["grid_reduce"] = r_rows[0]

        # grid_reduce_sums: the path's three groups, against the plain version
        # (each sum within 1e-5 of its sum |map|) and bit for bit against the
        # single grid_reduce calls they replace
        prod = nrm[0] * nrm[1]
        n = prod.numel()
        groups = [("ggd", tf.ggd_moments(), [nrm[0]], (float(n),) * 2),
                  ("aggd", tf.aggd_moments(), [prod], (1.0, 1.0, 1.0, 1.0, float(n), float(n))),
                  ("aggd_540x960", tf.aggd_moments(), [prod[:h2, :w2].contiguous()], (1.0,) * 6),
                  ("grayworld", tf.grayworld_sums(0.98), ch, (1.0,) * 4)]
        for label, a in ragged[1:] + [("33x1001 of 33x1004", wide[:, :1001]), ("33x1003 unaligned", wide[:, 1:])]:
            groups.append((f"aggd {label}", tf.aggd_moments(), [a], (1.0,) * 6))
        rgb_s = self.card(self.gen.uniform(0, 1, size=(37, 301, 3)))
        groups.append(("grayworld 37x301", tf.grayworld_sums(0.9), [rgb_s[..., c] for c in range(3)], (1.0,) * 4))
        sums_checks = []
        for label, group, xs, divs in groups:
            out = kr.grid_reduce_sums(group, *xs, div=divs)
            singles = torch.stack([kr.grid_reduce(m, *xs, div=d) for m, d in zip(group.maps, divs)])
            ref = kr.grid_reduce_sums_plain(group, *xs, div=divs)
            mag = torch.stack([kr.grid_reduce_plain(lambda *a, m=m: m.fn(*a).abs(), *xs) / d
                               for m, d in zip(group.maps, divs)])
            torch.cuda.synchronize()
            same = bool(torch.equal(out.view(torch.int32), singles.view(torch.int32)))
            err = (out - ref).abs()
            check(same, f"grid_reduce_sums {label}: {out.tolist()} differs from the single calls {singles.tolist()}")
            check(bool((err <= 1e-5 * mag).all()), f"grid_reduce_sums {label}: err {err.tolist()}, sum|.| {mag.tolist()}")
            sums_checks.append({"group": label, "shape": list(xs[0].shape),
                                "path": "vec4" if tf.vec4_path(xs) else "strided", "equal_to_single_calls": same,
                                "max_abs_err": float(err.max()), "max_err_over_sum_abs": float((err / mag).max())})
        aggd, divs = tf.aggd_moments(), (1.0, 1.0, 1.0, 1.0, float(n), float(n))
        self.aggd_row = self.row(
            "grid_reduce_sums", prod.shape, sums_checks[1]["max_abs_err"],
            {"": lambda: kr.grid_reduce_sums(aggd, prod, div=divs),
             "plain_": lambda: kr.grid_reduce_sums_plain(aggd, prod, div=divs),
             "singles_": lambda: [kr.grid_reduce(m, prod, div=d) for m, d in zip(aggd.maps, divs)],
             "library_": lambda: torch.stack([torch.sum(m.fn(prod)) / d for m, d in zip(aggd.maps, divs)])},
            4 * n + 4 * 6, 12 * n, REDUCE_KERNELS, cold=True, group="aggd",
            singles="six grid_reduce calls, one per map", library="six eager torch.sum of the maps")

        # grid_histogram: CLAHE's 8x8 tiles of a frame (the path's launch) and
        # the frame in both rules, each one launch; the three in turns; then
        # ragged images with NaN and out-of-range values on both walks
        gray = torch.clamp(u[3] * 1.1 - 0.05, -1.0, 2.0)
        h_rows, h_calls = [], []
        for label, rule, tiles, bins, vmin, vmax in (("clahe_tiles", "clamp", (8, 8), 256, 0.0, 1.0),
                                                      ("frame_clamp", "clamp", None, 256, 0.0, 1.0),
                                                      ("frame_drop", "drop", None, 256, 0.0, 1.0)):
            def hist(bins=bins, vmin=vmin, vmax=vmax, rule=rule, tiles=tiles):
                return kh.grid_histogram(gray, bins, vmin, vmax, rule=rule, tiles=tiles)

            out = hist()
            ref = kh.grid_histogram_plain(gray, bins, vmin, vmax, rule=rule, tiles=tiles)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            check(err == 0.0, f"grid_histogram {label}: counts differ by {err}")
            check(torch.equal(out.cpu(), kh.grid_histogram_plain(gray.cpu(), bins, vmin, vmax, rule, tiles)),
                  f"grid_histogram {label}: counts differ from the plain version on the CPU")
            h_calls.append((label, hist, out))
            launches = self.one_launch(hist, f"grid_histogram {label}", "grid_histogram_kernel")
            n_out = bins * (1 if tiles is None else tiles[0] * tiles[1])
            fns = {"": hist, "plain_": lambda: kh.grid_histogram_plain(gray, bins, vmin, vmax, rule, tiles)}
            if tiles is None:  # one PyTorch call histograms a frame; none a batch of tiles
                fns["library_"] = lambda: torch.histc(gray, bins=bins, min=vmin, max=vmax)
            ty, tx = tiles or (1, 1)
            tile_h, tile_w = gray.shape[0] // ty, gray.shape[1] // tx
            vec4 = kh.vec4_walk(gray, tile_h, tile_w, ty)
            h_rows.append(self.row("grid_histogram", gray.shape, err, fns, 4 * gray.numel() + 4 * n_out,
                                   4 * gray.numel(), ("grid_histogram_kernel",), cold=True, label=label, rule=rule,
                                   tiles=tiles, launches_per_call=launches, walk="vec4" if vec4 else "scalar",
                                   plan=kh.plan(tile_h, tile_w, ty * tx, vec4)))
        h_rows[0]["library_ms"] = None
        for turn in range(N_HIST_TURNS):
            for label, hist, first in h_calls:
                check(torch.equal(hist().view(torch.int32), first.view(torch.int32)),
                      f"grid_histogram {label}: turn {turn} changed the bits")
        h_ragged = []
        wide = self.card(self.gen.uniform(-0.5, 1.5, size=(200, 1028)))
        cases = [(f"{shape} tiles {tiles}", self.card(self.gen.uniform(-0.5, 1.5, size=shape)), tiles)
                 for shape, tiles in HIST_RAGGED_SHAPES]
        cases += [("200x1027 from column 1 (unaligned)", wide[:, 1:], (2, 2)),
                  ("200x1024 from column 1 (tiles of 512, 4 bytes off)", wide[:, 1:1025], (2, 2))]
        for label, a, tiles in cases:
            a[a > 1.4] = float("nan")
            a_cpu = a.cpu()
            ty, tx = tiles or (1, 1)
            tile_h, tile_w = a.shape[0] // ty, a.shape[1] // tx
            vec4 = kh.vec4_walk(a, tile_h, tile_w, ty)
            for rule in ("drop", "clamp"):
                for bins, vmin, vmax in HIST_RAGGED_BINS:
                    o = kh.grid_histogram(a, bins, vmin, vmax, rule=rule, tiles=tiles)
                    check(bool((o == kh.grid_histogram_plain(a, bins, vmin, vmax, rule, tiles)).all()),
                          f"grid_histogram ragged {label} {rule} {bins} [{vmin}, {vmax})")
                    # a witness off the card: the plain version on the CPU,
                    # whose division does not depend on the card's dispatch
                    check(bool((o.cpu() == kh.grid_histogram_plain(a_cpu, bins, vmin, vmax, rule, tiles)).all()),
                          f"grid_histogram ragged {label} {rule} {bins} [{vmin}, {vmax}) against the CPU")
            per_tile, _, spread = kh.plan(tile_h, tile_w, ty * tx, vec4)
            h_ragged.append({"case": label, "walk": "vec4" if vec4 else "scalar", "blocks_per_tile": per_tile,
                             "spread": spread})
        walks = {(r["walk"], r["blocks_per_tile"] > 1) for r in h_ragged}
        check(walks == {("vec4", True), ("vec4", False), ("scalar", True), ("scalar", False)}
              and any(r["spread"] > 1 for r in h_ragged) and h_rows[1]["plan"][2] > 1,
              f"grid_histogram ragged cases cover {walks}, spreads {[r['spread'] for r in h_ragged]}")
        check(not kh.vec4_walk(wide[:, 1:], 100, 513, 2) and not kh.vec4_walk(wide[:, 1:1025], 100, 512, 2)
              and kh.vec4_walk(wide[:, :1024], 100, 512, 2) and h_rows[0]["walk"] == "vec4", "grid_histogram walks")
        self.kernels["grid_histogram"] = h_rows[0]
        h_rows[0]["frame_ms"], h_rows[0]["frame_library_ms"] = h_rows[2]["ms"], h_rows[2]["library_ms"]
        self.l2_flush = None  # the later phases' peak memory leaves the flush buffer out
        emit({"phase": "k_grid_kernels",
              "tolerance": "transforms within 2 float32 ulp of the plain version (0 expected but for powf); sums "
                           "within 1e-5 of sum |map|; min and max exact; a rerun gives the same bits; "
                           "grid_reduce_sums equal to the single grid_reduce calls bit for bit; histogram counts "
                           "exact, one device launch a call, equal bits on calls in turns",
              "timing": "ms: device time per call (torch.profiler, 30 calls, inputs L2-warm where they fit in "
                        "the 50 MB L2), kernel_ms: the kernels' own in the same window; cold_ms: the same with a "
                        "128 MiB read before "
                        "each call (its kernels left out), for the kernel and the library call; bound_over_cold_ms: "
                        "the DRAM bound's share of the cold time; wall_ms: CUDA events per call",
              "library_call": {"grid_transform": "the map's eager PyTorch expression", "streamed_transform":
                               "torch.clamp(x, 0, 1) ** g", "grid_reduce": "torch.sum / amin / amax, F.mse_loss, "
                               "or the map's eager expression summed", "grid_reduce_sums": "six eager torch.sum of "
                               "the maps (no one PyTorch call computes them)",
                               "grid_histogram": "torch.histc (the frame; none for CLAHE's tiles)"},
              "grid_transform": t_rows, "streamed_transform": s_rows, "grid_reduce": r_rows,
              "grid_reduce_sums": {"checks": sums_checks, "aggd_six": self.aggd_row}, "grid_histogram": h_rows,
              "grid_histogram_ragged": h_ragged, "grid_histogram_turns": N_HIST_TURNS,
              "ok": True})

    # ---- (l) -----------------------------------------------------------------
    def photo_compare(self, res, ref, label, eq_tol=1e-6):
        """res against ref (entry.Photometric on any devices) at the CPU
        tests' tolerances, but for the equalized frames. CLAHE is a step
        function of its input: an ulp in the grayworld gains (whose sums
        the two paths take in other orders) moves a few pixels across a bin
        edge, each moved pixel changes its tile's LUT by 1 / (tile pixels)
        for every value above it, and the moved pixels change by a LUT
        step. So the equalized frames are held to a mean and a max."""
        torch = self.torch
        cpu = lambda t: t.detach().float().cpu()  # noqa: E731
        d_bal = float((cpu(res.balanced) - cpu(ref.balanced)).abs().max())
        d_eq = (cpu(res.equalized) - cpu(ref.equalized)).abs()
        off = int((d_eq > eq_tol).sum())
        f, fr = cpu(res.features), cpu(ref.features)
        rest = [i for i in range(36) if i not in ALPHA_FEATURES]
        alpha_steps = float((f[:, ALPHA_FEATURES] - fr[:, ALPHA_FEATURES]).abs().max())
        # the AGGD means are differences of two sigmas: their error is absolute
        rel_rest = float(((f[:, rest] - fr[:, rest]).abs() / (fr[:, rest].abs() + 1e-3)).max())
        rel = {k: float(((cpu(getattr(res, k)) - cpu(getattr(ref, k))).abs() / (cpu(getattr(ref, k)).abs() + 1.0))
                        .max()) for k in ("ssim", "gmsd", "nr_score")}
        rel["psnr"] = max(abs(a / b - 1.0) for a, b in zip(res.psnr, ref.psnr))
        out = {"balanced_max_abs": d_bal, "equalized_max_abs": float(d_eq.max()),
               "equalized_mean_abs": float(d_eq.mean()), "equalized_pixels_off": off,
               "equalized_share_off": off / d_eq.numel(), "features_alpha_max_diff": alpha_steps,
               "features_rest_max_rel": rel_rest, "scores_max_rel": rel}
        check(d_bal <= 1e-6 and float(d_eq.mean()) <= 1e-4 and float(d_eq.max()) <= 0.05
              and alpha_steps <= ALPHA_STEP and rel_rest <= 1e-4 and max(rel.values()) <= 1e-5,
              f"photometric {label}: {out}")
        return out

    def photometric(self):
        from opencv_contrib_tpu_torch import quality
        from opencv_contrib_tpu_torch.core.color import rgb_to_gray
        from opencv_contrib_tpu_torch.ops.cuda import histogram as kh
        from opencv_contrib_tpu_torch.ops.histogram import clahe

        torch, entry = self.torch, self.entry
        T, H, W = PHOTO_CLIP
        t0 = time.perf_counter()
        clean, degraded = entry.photo_clip(T, H, W, seed=0)
        clip_s = time.perf_counter() - t0
        cln, deg = self.card(clean), self.card(degraded)
        del clean, degraded
        entry.photometric(deg[:1], cln[:1])  # warm-up: cuDNN, the BRISQUE tables, allocator
        res, s = self.counted("photometric", lambda: entry.photometric(deg, cln))
        launches = {k: self.launches["photometric"][k] for k in PATH_KERNELS["photometric"]}
        expect = {"streamed_transform": 1, **{k: v * T for k, v in PHOTO_PER_FRAME.items()}}
        check(launches == expect, f"photometric launches per clip {launches}, expected {expect}")
        check(tuple(res.balanced.shape) == (T, H, W, 3) and tuple(res.equalized.shape) == (T, H, W)
              and tuple(res.features.shape) == (T, 36), "photometric shapes")
        for k in ("balanced", "equalized", "ssim", "gmsd", "nr_score", "features"):
            check(bool(torch.isfinite(getattr(res, k)).all()), f"photometric {k} not finite")
        check(float(res.balanced.min()) >= 0.0 and float(res.balanced.max()) <= 1.0
              and float(res.equalized.min()) >= 0.0 and float(res.equalized.max()) <= 1.0, "photometric range")
        # restoration gate: the gamma and the white balance bring the degraded
        # clip nearer the clean one (PSNR of the gray frames, dB)
        gain_db = []
        for t in range(T):
            ref = rgb_to_gray(cln[t])
            gain_db.append(quality.psnr(rgb_to_gray(res.balanced[t]), ref) - quality.psnr(rgb_to_gray(deg[t]), ref))
        check(min(gain_db) > 3.0, f"white balance + gamma gain {gain_db} dB")
        # CLAHE's tile histograms of frame 0, kernel against plain, on the path's gray frame
        g0 = rgb_to_gray(res.balanced[0])
        hk = kh.grid_histogram(g0, 256, 0.0, 1.0, rule="clamp", tiles=(8, 8))
        hp = kh.grid_histogram_plain(g0, 256, 0.0, 1.0, rule="clamp", tiles=(8, 8))
        check(bool((hk == hp).all()), "CLAHE tile counts differ from the plain version")
        eq_k = clahe(g0)
        with plain_path():
            eq_p = clahe(g0)
        clahe_same_input = float((eq_k - eq_p).abs().max())
        check(clahe_same_input == 0.0, f"CLAHE on one gray frame, kernel against plain: {clahe_same_input}")

        with plain_path():
            plain = entry.photometric(deg, cln)
        vs_plain = self.photo_compare(res, plain, "plain path on the card")
        del plain

        Ts, Hs, Ws = PHOTO_SMALL
        cs, ds = entry.photo_clip(Ts, Hs, Ws, seed=1)
        vs_cpu = self.photo_compare(entry.photometric(ds, cs), entry.photometric(ds, cs, device="cpu"),
                                    "small clip, card vs CPU")

        ms = []
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(N_PHOTO_TIMED):
            _, t = self.wall_s(lambda: entry.photometric(deg, cln))
            ms.append(t * 1e3 / T)
        peak = torch.cuda.max_memory_allocated()
        emit({"phase": "l_photometric", "clip": [T, H, W, 3], "clip_made_s": clip_s, "s_main_path": s,
              "launches": self.launches["photometric"], "launches_per_clip": launches,
              "restoration_gain_db": gain_db,
              "scores": {"psnr": res.psnr, "ssim": res.ssim.tolist(), "gmsd": res.gmsd.tolist(),
                         "nr_score": res.nr_score.tolist(), "features_0": res.features[0].tolist()},
              "plain_path_vs_kernel": vs_plain, "small_card_vs_cpu": vs_cpu,
              "clahe_one_frame_kernel_vs_plain_max_abs": clahe_same_input,
              "ms_per_frame_median": float(np.median(ms)), "ms_per_frame": ms,
              "host_syncs_per_frame": 1,  # quality.psnr reads the MSE back as a float
              "peak_mem_allocated_gb": peak / 2 ** 30, "peak_mem_of_a_clip_gb": (peak - held) / 2 ** 30,
              "profile_one_frame": self.profile_photo(deg[:1], cln[:1]),
              "tolerance": "balanced 1e-6; equalized mean abs <= 1e-4 and max <= 0.05 (CLAHE on one gray frame, "
                           "kernel against plain: equal); scores |d| <= 1e-5 (|ref| + 1), psnr rtol 1e-5; BRISQUE "
                           "alphas one grid step, the rest |d| <= 1e-4 (|ref| + 1e-3); tile counts exact; "
                           "restoration gain > 3 dB a frame",
              "timing": f"ms_per_frame: host clock around one synchronised clip / {T}, {N_PHOTO_TIMED} warm runs",
              "ok": True})

    def profile_photo(self, deg, cln) -> dict:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = self.wall_s(lambda: self.entry.photometric(deg, cln))
        ev = kernel_events(prof)
        busy_us = sum(e.self_device_time_total for e in ev)
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:10]
        ours = {}
        for e in ev:  # summed over each kernel's template instantiations (one per map)
            for k in DEVICE_KERNELS:
                if is_ours(e.key, k):
                    row = ours.setdefault(k, {"count": 0, "us": 0.0})
                    row["count"] += e.count
                    row["us"] += e.self_device_time_total
        return {"wall_s_under_profiler": wall, "device_busy_s": busy_us * 1e-6,
                "device_busy_share": busy_us * 1e-6 / wall, "device_launches": sum(e.count for e in ev),
                "top_device": [{"name": e.key[:80], "count": e.count, "us": e.self_device_time_total} for e in top],
                "our_kernels": {k: {**v, "us_per_launch": v["us"] / v["count"]} for k, v in ours.items()}}

    # ---- (m) -----------------------------------------------------------------
    def sfm(self):
        from opencv_contrib_tpu_torch.sfm import pipeline
        from opencv_contrib_tpu_torch.utils import tracing

        torch, entry = self.torch, self.entry
        tracks, intr = entry.sfm_scene()
        n_obs = int(tracks.mask.sum())
        check(n_obs < pipeline.SPARSE_BA_OBS_THRESHOLD, f"{n_obs} markers: above the dense driver's threshold")

        def run():
            return pipeline.reconstruct_incremental(tracks, intr, refine_intrinsics=True)

        rec, s_first = self.counted("sfm", run)  # also the warm-up (cuSOLVER handles, the allocator)
        check(all(v == 0 for v in self.launches["sfm"].values()), f"sfm launched a kernel: {self.launches['sfm']}")
        n_reg, n_pts = int(rec.registered.sum()), int(rec.has_point.sum())
        mean_px, rms_px = rec.reprojection_mean(tracks), rec.reprojection_rms(tracks)
        check(n_reg >= SFM_MIN_VIEWS and n_pts >= SFM_MIN_POINT_SHARE * tracks.n_tracks
              and mean_px <= SFM_MEAN_PX_GATE, f"sfm gates: {n_reg} views, {n_pts} points, mean {mean_px} px")
        check(bool(np.isfinite(rec.points[rec.has_point]).all()) and bool(np.isfinite(rec.intr).all()),
              "sfm output not finite")

        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tracing.reset_spans()
        wall = [self.wall_s(run)[1] for _ in range(N_SFM_TIMED)]
        spans = {k[len(SFM_PREFIX):]: {**v, "mean_ms_per_run": 1e3 * v["total_s"] / N_SFM_TIMED}
                 for k, v in tracing.span_stats().items()}
        peak = torch.cuda.max_memory_allocated()
        check(set(spans) == SFM_SPANS, f"sfm spans {sorted(spans)}")

        parts = {"first_run": s_first, "timed_runs": float(sum(wall))}
        t0 = time.perf_counter()
        syncs = self.count_syncs(run)
        parts["sync_count_run"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        profiled = self.profile_sfm(run)
        parts["profiled_run_and_parse"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small = self.sfm_card_vs_cpu()
        parts["small_card_and_cpu"] = time.perf_counter() - t0
        emit({"phase": "m_sfm", "scene": "entry.sfm_scene(): generate_scene(100, 900, seed=4, noise_px=0.5, "
                                         "distortion=True)", "views": tracks.n_views, "tracks": tracks.n_tracks,
              "markers": n_obs, "sparse_threshold": pipeline.SPARSE_BA_OBS_THRESHOLD,
              "launches": self.launches["sfm"], "registered": n_reg, "points": n_pts,
              "reprojection_mean_px": mean_px, "reprojection_rms_px": rms_px,
              "intr_refined": rec.intr.tolist(), "intr_true": np.asarray(intr).tolist(),
              "log_head": [list(r) for r in rec.log[:3]], "rounds": sum(r[0] == "round" for r in rec.log),
              "s_first_run": s_first, "s_per_reconstruction_median": float(np.median(wall)), "s_warm": wall,
              "host_span_ms": spans, "host_syncs_per_run": syncs,
              "peak_mem_allocated_gb": peak / 2 ** 30, "peak_mem_of_a_run_gb": (peak - held) / 2 ** 30,
              "profile_one_run": profiled, "small_card_vs_cpu": small, "phase_parts_s": parts,
              "tolerance": f"gates: registered >= {SFM_MIN_VIEWS}, points >= {SFM_MIN_POINT_SHARE} x tracks, mean "
                           f"reprojection <= {SFM_MEAN_PX_GATE} px; small scene card vs CPU with the same draws: "
                           "registered equal, points within max(2, 1%) of the tracks, rms and mean px within "
                           f"{SFM_CPU_TOL['rms_px']}, aligned points within {SFM_CPU_TOL['aligned_points']} RMS, "
                           f"focal rtol {SFM_CPU_TOL['focal_rtol']}, principal point {SFM_CPU_TOL['pp_px']} px, "
                           f"k1 and k2 {SFM_CPU_TOL['k12']}",
              "timing": f"s_per_reconstruction: host clock around one synchronised reconstruction, the median of "
                        f"{N_SFM_TIMED} warm runs after the counted first run; host_span_ms over those runs",
              "ok": True})

    @contextlib.contextmanager
    def sync_log(self):
        """The warnings of torch.cuda.set_sync_debug_mode("warn") while the
        block runs, in the yielded list."""
        import warnings

        torch = self.torch
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield got
            finally:
                torch.cuda.set_sync_debug_mode(0)

    @staticmethod
    def sync_summary(got) -> dict:
        """Host syncs among logged warnings: in total, those made from a line
        of the port, and by the line that made them."""
        syncs = [w for w in got if "synchroniz" in str(w.message)]
        sites = {}
        for w in syncs:
            site = f"{w.filename.rsplit('opencv_contrib_tpu_torch/', 1)[-1]}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
        top = sorted(sites.items(), key=lambda kv: -kv[1])[:12]
        return {"total": len(syncs), "in_the_port": sum("opencv_contrib_tpu_torch/" in w.filename for w in syncs),
                "top_sites": dict(top)}

    def count_syncs(self, fn) -> dict:
        """Host syncs of one call of fn (`sync_summary`)."""
        with self.sync_log() as got:
            fn()
        return self.sync_summary(got)

    def profile_sfm(self, run) -> dict:
        """One reconstruction under torch.profiler, read from the raw kineto
        events (`kineto_rows`): building the profiler's event tree for a
        run's ~0.5 M events took 98 s."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = self.wall_s(run)
        return self.kineto_rows(prof, wall, SFM_PREFIX, SFM_SPANS)

    def kineto_rows(self, prof, wall: float, prefix: str, names, require: bool = True) -> dict:
        """A finished profile whose window took `wall` s: device busy time and
        launches, the top device operations, and per span (disjoint, named
        `prefix` + one of `names`; with `require`, each in the window) the
        count, the host ms and the device ms and launches of the kernels whose
        launching op started inside it (op and kernel joined by correlation
        id, as the profiler's own tree joins them)."""
        import bisect

        from torch.autograd import DeviceType

        spans, op_start, kernels = [], {}, []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith(prefix):  # a span's device-side copy
                    kernels.append((e.linked_correlation_id(), name, e.duration_ns()))
            elif name.startswith(prefix):
                spans.append((e.start_ns(), e.end_ns(), name[len(prefix):]))
            elif e.linked_correlation_id() == 0 and not e.is_async():  # an op, not a runtime call
                op_start[e.correlation_id()] = e.start_ns()
        spans.sort()
        starts = [sp[0] for sp in spans]
        outside = "(outside the spans)"
        rows = {n: {"count": 0, "host_ms": 0.0, "device_ms": 0.0, "launches": 0} for n in sorted(names) + [outside]}
        for t0, t1, n in spans:
            rows[n]["count"] += 1
            rows[n]["host_ms"] += (t1 - t0) / 1e6
        by_name = {}
        for corr, name, dur in kernels:
            t = op_start.get(corr)
            k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            row = rows[spans[k][2] if k >= 0 and t <= spans[k][1] else outside]
            row["device_ms"] += dur / 1e6
            row["launches"] += 1
            agg = by_name.setdefault(name, [0, 0])
            agg[0] += 1
            agg[1] += dur
        check(not require or {n for _, _, n in spans} == set(names),
              f"spans in the trace: {sorted({n for _, _, n in spans})}")
        busy_s = sum(d for _, _, d in kernels) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"wall_s_under_profiler": wall, "device_busy_s": busy_s, "device_busy_share": busy_s / wall,
                "device_launches": len(kernels), "spans": rows,
                "top_device": [{"name": k[:80], "count": c, "us": d / 1e3} for k, (c, d) in top]}

    def sfm_card_vs_cpu(self) -> dict:
        """A small scene on the card and on the CPU, both drawing their RANSAC
        samples from a CPU generator of one seed (the same draws wherever the
        two runs hold the same state), compared by the rules of
        SFM_CPU_TOL."""
        from opencv_contrib_tpu_torch.mvg import robust
        from opencv_contrib_tpu_torch.sfm import pipeline

        tracks, intr = self.entry.sfm_scene(*SFM_SMALL)
        draw = robust.sample_indices
        recs = {}
        for dev in ("cuda", "cpu"):
            gen = self.torch.Generator().manual_seed(0)

            def same_draws(generator, n_points, mask, n_hypotheses, sample_size, gen=gen):
                return draw(gen, n_points, mask.cpu(), n_hypotheses, sample_size).to(mask.device)

            with mock.patch.object(robust, "sample_indices", same_draws):
                recs[dev] = pipeline.reconstruct_incremental(tracks, intr, refine_intrinsics=True, device=dev)
        card, cpu = recs["cuda"], recs["cpu"]
        both = card.has_point & cpu.has_point
        out = {"views_tracks": list(SFM_SMALL), "registered": [int(card.registered.sum()), int(cpu.registered.sum())],
               "points": [int(card.has_point.sum()), int(cpu.has_point.sum())],
               "rms_px": [card.reprojection_rms(tracks), cpu.reprojection_rms(tracks, device="cpu")],
               "mean_px": [card.reprojection_mean(tracks), cpu.reprojection_mean(tracks, device="cpu")],
               "aligned_points_rms": similarity_rms(card.points[both], cpu.points[both]),
               "intr": [card.intr.tolist(), cpu.intr.tolist()], "same_log": card.log == cpu.log,
               "log_diff": log_diff(card.log, cpu.log)}
        tol = SFM_CPU_TOL
        check(bool((card.registered == cpu.registered).all())
              and abs(out["points"][0] - out["points"][1]) <= max(2, tol["points"] * tracks.n_tracks)
              and abs(out["rms_px"][0] - out["rms_px"][1]) <= tol["rms_px"]
              and abs(out["mean_px"][0] - out["mean_px"][1]) <= tol["rms_px"]
              and out["aligned_points_rms"] <= tol["aligned_points"]
              and np.allclose(card.intr[:2], cpu.intr[:2], rtol=tol["focal_rtol"], atol=0)
              and np.abs(card.intr[2:4] - cpu.intr[2:4]).max() <= tol["pp_px"]
              and np.abs(card.intr[4:6] - cpu.intr[4:6]).max() <= tol["k12"], f"sfm small scene, card vs CPU: {out}")
        return out

    # ---- (n) -----------------------------------------------------------------
    def sparse_ba(self):
        parts = {}
        t0 = time.perf_counter()
        big = self.sparse_big()
        parts["two_million"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small = self.sparse_card_vs_cpu()
        parts["small_card_and_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        driver = self.sparse_driver()
        parts["driver"] = time.perf_counter() - t0
        emit({"phase": "n_sparse_ba", "two_million": big, "small_card_vs_cpu": small, "driver": driver,
              "phase_parts_s": parts,
              "tolerance": f"2M: final cost < {SPARSE_BIG_GATE} x initial, a rerun equal bit for bit; small: final "
                           f"costs rtol {SPARSE_CPU_TOL['cost_rtol']}, cameras and points within "
                           f"{SPARSE_CPU_TOL['params']}; driver: >= 1 sparse bundle, registered >= "
                           f"{SFM_SPARSE_MIN_VIEW_SHARE} x views, points >= {SFM_MIN_POINT_SHARE} x tracks, mean "
                           f"reprojection <= {SFM_MEAN_PX_GATE} px",
              "timing": "device_ms_per_lm_iteration: torch.profiler kernel time of a 3-iteration solve less that "
                        "of a 1-iteration solve, over 2; wall_ms: host clock around a synchronised solve",
              "ok": True})

    def sparse_big(self) -> dict:
        """tests/test_scale_tpu.py's 2M-observation problem on the card."""
        from opencv_contrib_tpu_torch.ba import sparse

        torch = self.torch
        C, P, N = SPARSE_BIG
        t0 = time.perf_counter()
        prob, buckets = two_million_problem(self.dev)
        s_buckets = time.perf_counter() - t0

        def solve(n_iters=SPARSE_BIG_ITERS):
            return sparse.bundle_adjust_sparse(prob, n_iters=n_iters, n_cg=SPARSE_BIG_CG, buckets=buckets)

        res, s_first = self.wall_s(solve)
        c0, c1 = float(res.initial_cost), float(res.final_cost)
        check(np.isfinite(c1) and c1 < SPARSE_BIG_GATE * c0, f"2M sparse BA: cost {c0} -> {c1}")
        again = solve()
        check(all(torch.equal(a, b) for a, b in zip(res, again)), "2M sparse BA: a rerun changed the bits")
        wall = [self.wall_s(solve)[1] for _ in range(N_SPARSE_TIMED)]
        syncs = {n: self.count_syncs(lambda: solve(n)) for n in (1, SPARSE_BIG_ITERS)}
        check(syncs[1]["in_the_port"] == syncs[SPARSE_BIG_ITERS]["in_the_port"],
              f"2M sparse BA: host syncs grow with the LM iterations: {syncs}")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        solve()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        ev = {n: self.device_events(lambda: solve(n), iters=1) for n in (1, SPARSE_BIG_ITERS)}
        dev_ms = {n: sum(e.self_device_time_total for e in v) / 1e3 for n, v in ev.items()}
        top = sorted(ev[SPARSE_BIG_ITERS], key=lambda e: -e.self_device_time_total)[:10]
        out = {"cameras": C, "points": P, "observations": N, "bucket_slots": list(buckets.idx_a.shape),
               "lm_iters": SPARSE_BIG_ITERS, "cg_iters": SPARSE_BIG_CG, "initial_cost": c0, "final_cost": c1,
               "same_bits_on_rerun": True, "s_problem_and_buckets": s_buckets, "s_first_solve": s_first,
               "wall_ms_solve": [1e3 * w for w in wall], "device_ms_solve": dev_ms,
               "device_ms_per_lm_iteration": (dev_ms[SPARSE_BIG_ITERS] - dev_ms[1]) / (SPARSE_BIG_ITERS - 1),
               "device_launches_solve": sum(e.count for e in ev[SPARSE_BIG_ITERS]),
               "host_syncs_solve": syncs, "peak_mem_of_a_solve_gb": peak / 2 ** 30,
               "top_device": [{"name": e.key[:80], "count": e.count, "us": e.self_device_time_total} for e in top]}
        del prob, buckets, res, again
        torch.cuda.empty_cache()
        return out

    def sparse_card_vs_cpu(self) -> dict:
        """tests/test_ba_sparse.py's 64 x 4096 x 8 problem with pixel noise, one
        set of numpy inputs solved on the card and on the CPU."""
        import torch

        from opencv_contrib_tpu_torch.ba import sparse
        from opencv_contrib_tpu_torch.core import se3
        from opencv_contrib_tpu_torch.utils.synthetic import generate_scene

        rng = np.random.default_rng(1)
        C, P, k = SPARSE_SMALL
        scene = generate_scene(n_views=C, n_points=64, seed=2)  # poses only
        pts = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
        obs_cam = np.stack([rng.choice(C, k, replace=False) for _ in range(P)]).reshape(-1).astype(np.int32)
        obs_pt = np.repeat(np.arange(P, dtype=np.int32), k)
        cams6 = torch.cat([se3.log_so3(torch.from_numpy(scene.Rs)), torch.from_numpy(scene.ts)], dim=1)
        uv = sparse._project_cf(cams6[obs_cam].T, torch.from_numpy(pts)[obs_pt].T, torch.from_numpy(scene.intr))
        noisy = pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
        uv = uv.numpy() + np.random.default_rng(5).normal(scale=SPARSE_SMALL_NOISE_PX, size=uv.shape).astype(
            np.float32)
        inputs = (cams6.numpy(), noisy, scene.intr, obs_cam, obs_pt, uv, np.ones(len(obs_cam), bool))
        res = {}
        for dev in ("cuda", "cpu"):
            prob = sparse.SparseBAProblem(*(torch.as_tensor(a, device=dev) for a in inputs))
            r = sparse.bundle_adjust_sparse(prob, n_iters=SPARSE_SMALL_ITERS, n_cg=SPARSE_SMALL_CG)
            res[dev] = [x.cpu().numpy() for x in r]
        card, cpu = res["cuda"], res["cpu"]
        out = {"shape": list(SPARSE_SMALL), "noise_px": SPARSE_SMALL_NOISE_PX, "initial_cost": [float(card[2]),
               float(cpu[2])], "final_cost": [float(card[3]), float(cpu[3])],
               "cost_rel": abs(float(card[3]) / float(cpu[3]) - 1.0),
               "cameras_max_abs": float(np.abs(card[0] - cpu[0]).max()),
               "points_max_abs": float(np.abs(card[1] - cpu[1]).max())}
        check(out["cost_rel"] <= SPARSE_CPU_TOL["cost_rtol"] and out["final_cost"][0] < 0.2 * out["initial_cost"][0]
              and max(out["cameras_max_abs"], out["points_max_abs"]) <= SPARSE_CPU_TOL["params"],
              f"sparse BA card vs CPU: {out}")
        return out

    def sparse_driver(self) -> dict:
        """reconstruct_incremental above the sparse threshold, with a spy on
        the sparse route."""
        from opencv_contrib_tpu_torch.sfm import pipeline
        from opencv_contrib_tpu_torch.utils import tracing

        tracks, intr = self.entry.sfm_scene(*SFM_SPARSE)
        n_obs = int(tracks.mask.sum())
        check(n_obs > pipeline.SPARSE_BA_OBS_THRESHOLD, f"{n_obs} markers: under the sparse threshold")
        calls = []
        route = pipeline._run_bundle_sparse

        def spy(rec, tr, mask, *a, **k):
            calls.append(int(mask.sum()))
            return route(rec, tr, mask, *a, **k)

        def run():
            return pipeline.reconstruct_incremental(tracks, intr, refine_intrinsics=True)

        with mock.patch.object(pipeline, "_run_bundle_sparse", spy):
            rec, s_first = self.counted("sfm_sparse", run)
            n_calls = len(calls)
            check(all(v == 0 for v in self.launches["sfm_sparse"].values()),
                  f"sfm_sparse launched a kernel: {self.launches['sfm_sparse']}")
            n_reg, n_pts = int(rec.registered.sum()), int(rec.has_point.sum())
            mean_px, rms_px = rec.reprojection_mean(tracks), rec.reprojection_rms(tracks)
            check(n_calls >= 1 and n_reg >= SFM_SPARSE_MIN_VIEW_SHARE * tracks.n_views
                  and n_pts >= SFM_MIN_POINT_SHARE * tracks.n_tracks and mean_px <= SFM_MEAN_PX_GATE,
                  f"sfm above the threshold: {n_calls} sparse bundles, {n_reg} views, {n_pts} points, "
                  f"mean {mean_px} px")
            check(bool(np.isfinite(rec.points[rec.has_point]).all()), "sfm above the threshold: points not finite")
            tracing.reset_spans()
            _, s_warm = self.wall_s(run)
            spans = {k[len(SFM_PREFIX):]: 1e3 * v["total_s"] for k, v in tracing.span_stats().items()}
            syncs = self.count_syncs(run)
        return {"scene": f"entry.sfm_scene{SFM_SPARSE}", "views": tracks.n_views, "tracks": tracks.n_tracks,
                "markers": n_obs, "sparse_threshold": pipeline.SPARSE_BA_OBS_THRESHOLD,
                "sparse_bundles_first_run": n_calls, "sparse_bundle_observations": calls[:n_calls],
                "launches": self.launches["sfm_sparse"], "registered": n_reg, "points": n_pts,
                "reprojection_mean_px": mean_px, "reprojection_rms_px": rms_px, "intr_refined": rec.intr.tolist(),
                "rounds": sum(r[0] == "round" for r in rec.log), "s_first_run": s_first, "s_warm_run": s_warm,
                "host_span_ms_warm_run": spans, "host_syncs_per_run": syncs}

    # ---- (o) -----------------------------------------------------------------
    def sfm_scale(self):
        parts = {}
        t0 = time.perf_counter()
        main_run = self.scale_run()
        parts["main_run"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        profiled = self.scale_profiled()
        parts["profiled_256"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small = self.scale_card_vs_cpu()
        parts["small_card_and_cpu"] = time.perf_counter() - t0
        emit({"phase": "o_sfm_scale", "main_run": main_run, "profiled_256": profiled, "small_card_vs_cpu": small,
              "phase_parts_s": parts,
              "tolerance": f"{SFM_SCALE[0]} views: registered >= {SFM_SCALE_MIN_VIEW_SHARE} x views, mean "
                           f"reprojection <= {SFM_MEAN_PX_GATE} px, points on >= {SFM_SCALE_MIN_POINT_SHARE} x "
                           f"tracks, finite, ATE < {SFM_SCALE_ATE} on every {SFM_SCALE_ATE_WINDOW}-view window of "
                           f"the dominant segment; 256: registered >= "
                           f"{SFM_SCALE_PROFILED_MIN_VIEWS}, mean <= {SFM_MEAN_PX_GATE} px; small: registered and "
                           f"reg_order equal, mean px within {SFM_SCALE_CPU_TOL['mean_px']}, aligned points within "
                           f"{SFM_SCALE_CPU_TOL['aligned_points']} RMS; no kernel of ours launched",
              "timing": "wall_s: host clock around one synchronised reconstruction (run once, with the sync log "
                        "on); host_span_ms from utils.tracing spans; the 256 run's device ms, launches and top ops "
                        "from the raw kineto events of its profiled window (chunks and all between them; the "
                        "profiler slows the host there)",
              "ok": True})

    @contextlib.contextmanager
    def scale_steps(self, got=None):
        """Spans (utils.tracing.trace_span) around the 5k driver's device
        steps, so each step's count, host and device ms and launches can be
        read, and, given a sync log `got`, its host syncs (the yielded dict,
        by step)."""
        from opencv_contrib_tpu_torch.sfm import pipeline_scale
        from opencv_contrib_tpu_torch.utils.tracing import trace_span

        syncs = {}

        def wrap(fn, name):
            def step(*a, **k):
                i0 = len(got) if got is not None else 0
                with trace_span(SCALE_PREFIX + name):
                    out = fn(*a, **k)
                if got is not None:
                    syncs[name] = syncs.get(name, 0) + sum("synchroniz" in str(w.message) for w in got[i0:])
                return out

            return step

        with contextlib.ExitStack() as stack:
            for attr, name in SCALE_STEPS.items():
                stack.enter_context(mock.patch.object(pipeline_scale, attr, wrap(getattr(pipeline_scale, attr), name)))
            yield syncs

    def scale_run(self) -> dict:
        """The sequential reconstruction at SFM_SCALE, once, with its gates."""
        from opencv_contrib_tpu_torch.sfm import pipeline_scale
        from opencv_contrib_tpu_torch.utils import metrics, tracing

        torch = self.torch
        t0 = time.perf_counter()
        tracks, intr, scene = self.entry.sfm_sequence_scene(*SFM_SCALE)
        s_scene = time.perf_counter() - t0
        V, T = tracks.n_views, tracks.n_tracks

        def run():
            return pipeline_scale.reconstruct_sequential(tracks, intr, **SFM_SCALE_RUN)

        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tracing.reset_spans()
        with self.sync_log() as got, self.scale_steps(got) as step_syncs:
            rec, wall = self.counted("sfm_scale", run)
        peak = torch.cuda.max_memory_allocated() - held
        spans = {k[len(SCALE_PREFIX):]: {kk: v[kk] for kk in ("count", "total_s", "mean_ms", "max_ms")}
                 for k, v in tracing.span_stats().items() if k.startswith(SCALE_PREFIX)}
        check(all(v == 0 for v in self.launches["sfm_scale"].values()),
              f"sfm_scale launched a kernel: {self.launches['sfm_scale']}")
        n_reg, n_pts = int(rec.registered.sum()), int(rec.has_point.sum())
        mean_px = rec.reprojection_mean_px(tracks)
        c_est = np.einsum("vij,vi->vj", rec.Rs, -rec.ts)
        c_gt = np.einsum("vij,vi->vj", scene.Rs, -scene.ts)
        segs, counts = np.unique(rec.seg_of_view[rec.registered], return_counts=True)
        main = rec.registered & (rec.seg_of_view == segs[np.argmax(counts)])
        idx = np.flatnonzero(main)
        ate = metrics.ate_rmse(c_est[idx], c_gt[idx])
        ate_eighths = [metrics.ate_rmse(c_est[w], c_gt[w]) for w in np.array_split(idx, 8)]
        ate_windows = [metrics.ate_rmse(c_est[w], c_gt[w])
                       for w in np.array_split(idx, max(1, len(idx) // SFM_SCALE_ATE_WINDOW))]
        syncs = self.sync_summary(got)
        out = {"views": V, "cut_from_views": 5000, "slots": tracks.slots, "tracks": T,
               "observations": int(tracks.ok.sum()),
               "track_span": max(24, V // 125), "settings": SFM_SCALE_RUN, "s_scene": s_scene,
               "registered": n_reg, "segments": rec.n_segments, "points": n_pts, "reprojection_mean_px": mean_px,
               "ate_dominant_segment": ate, "dominant_segment_views": int(main.sum()),
               "ate_dominant_segment_eighths": ate_eighths, "ate_96_view_windows_max": max(ate_windows),
               "segment_views": counts.tolist(),
               "fails": sum(e[0] == "fail" for e in rec.log), "reinits": sum(e[0] == "reinit" for e in rec.log),
               "log_head": [list(e) for e in rec.log[:4]], "wall_s": wall, "keyframes_per_s": n_reg / wall,
               "host_span_ms": spans, "host_syncs": {**syncs, "by_step": step_syncs,
                                                      "in_the_port_per_view": syncs["in_the_port"] / V},
               "launches": self.launches["sfm_scale"], "peak_mem_of_the_run_gb": peak / 2 ** 30,
               "peak_mem_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        check(n_reg >= SFM_SCALE_MIN_VIEW_SHARE * V and mean_px <= SFM_MEAN_PX_GATE
              and n_pts >= SFM_SCALE_MIN_POINT_SHARE * T and max(ate_windows) < SFM_SCALE_ATE
              and bool(np.isfinite(rec.points[rec.has_point]).all()), f"sfm_scale gates: {out}")
        del tracks, rec
        torch.cuda.empty_cache()
        return out

    def scale_profiled(self) -> dict:
        """tests/test_scale_tpu.py's 256 x 1,024 run, once: its gates, the
        host syncs and host ms of each step, and a profile of the chunks
        SFM_SCALE_PROFILED_WINDOW and all between them (parsing a whole run's
        ~7 M events would take minutes)."""
        from torch.profiler import ProfilerActivity, profile

        from opencv_contrib_tpu_torch.sfm import pipeline_scale
        from opencv_contrib_tpu_torch.utils import tracing

        torch = self.torch
        tracks, intr, _ = self.entry.sfm_sequence_scene(*SFM_SCALE_PROFILED)
        k0, k1 = SFM_SCALE_PROFILED_WINDOW
        win = {"calls": 0, "wall": None}
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def windowed(fn):
            def chunk(*a, **k):
                if win["calls"] in (k0, k1):
                    torch.cuda.synchronize()
                    if win["calls"] == k0:
                        prof.__enter__()
                        win["t0"] = time.perf_counter()
                    else:
                        win["wall"] = time.perf_counter() - win["t0"]
                        prof.__exit__(None, None, None)
                win["calls"] += 1
                return fn(*a, **k)

            return chunk

        def run():
            return pipeline_scale.reconstruct_sequential(tracks, intr, **SFM_SCALE_PROFILED_RUN)

        tracing.reset_spans()
        with self.sync_log() as got, self.scale_steps(got) as step_syncs:
            with mock.patch.object(pipeline_scale, "_chunk_register_jit", windowed(pipeline_scale._chunk_register_jit)):
                rec, wall = self.wall_s(run)
        check(win["wall"] is not None, f"the profiled window never closed: {win['calls']} chunks")
        spans = {k[len(SCALE_PREFIX):]: v for k, v in tracing.span_stats().items() if k.startswith(SCALE_PREFIX)}
        n_reg, mean_px = int(rec.registered.sum()), rec.reprojection_mean_px(tracks)
        check(n_reg >= SFM_SCALE_PROFILED_MIN_VIEWS and mean_px <= SFM_MEAN_PX_GATE,
              f"sfm_scale 256 gates: {n_reg} views, mean {mean_px} px")
        t0 = time.perf_counter()
        rows = self.kineto_rows(prof, win["wall"], SCALE_PREFIX, set(SCALE_STEPS.values()), require=False)
        s_parse = time.perf_counter() - t0
        per = {n: {"count": r["count"], "launches_each": r["launches"] / max(r["count"], 1),
                   "device_ms_each": r["device_ms"] / max(r["count"], 1),
                   "host_ms_each": r["host_ms"] / max(r["count"], 1)} for n, r in rows["spans"].items()}
        for n, c in step_syncs.items():
            per.setdefault(n, {})["syncs_each_whole_run"] = c / max(spans.get(n, {}).get("count", 1), 1)
        return {"views": tracks.n_views, "slots": tracks.slots, "tracks": tracks.n_tracks,
                "settings": SFM_SCALE_PROFILED_RUN, "registered": n_reg, "segments": rec.n_segments,
                "reprojection_mean_px": mean_px, "wall_s": wall, "s_parse": s_parse, "host_span_ms": spans,
                "host_syncs": {**self.sync_summary(got), "by_step": step_syncs},
                "profiled_chunks": [k0, k1], "profile_window": rows, "per_step_in_window": per}

    def scale_card_vs_cpu(self) -> dict:
        """A noise-free 48 x 48 orbit on the card and on the CPU, both drawing
        their RANSAC samples from a CPU generator of one seed."""
        from opencv_contrib_tpu_torch.mvg import robust
        from opencv_contrib_tpu_torch.sfm import pipeline_scale
        from opencv_contrib_tpu_torch.utils.synthetic import generate_sequence_scene

        sc = generate_sequence_scene(**SFM_SCALE_SMALL)
        tracks = pipeline_scale.from_sequence_scene(sc)
        draw = robust.sample_indices
        recs = {}
        for dev in ("cuda", "cpu"):
            gen = self.torch.Generator().manual_seed(0)

            def same_draws(generator, n_points, mask, n_hypotheses, sample_size, gen=gen):
                return draw(gen, n_points, mask.cpu(), n_hypotheses, sample_size).to(mask.device)

            with mock.patch.object(robust, "sample_indices", same_draws):
                recs[dev] = pipeline_scale.reconstruct_sequential(tracks, sc.intr, device=dev, **SFM_SCALE_SMALL_RUN)
        card, cpu = recs["cuda"], recs["cpu"]
        both = card.has_point & cpu.has_point
        out = {"scene": SFM_SCALE_SMALL, "settings": SFM_SCALE_SMALL_RUN,
               "registered": [int(card.registered.sum()), int(cpu.registered.sum())],
               "same_reg_order": card.reg_order == cpu.reg_order, "segments": [card.n_segments, cpu.n_segments],
               "points": [int(card.has_point.sum()), int(cpu.has_point.sum())],
               "mean_px": [card.reprojection_mean_px(tracks), cpu.reprojection_mean_px(tracks, device="cpu")],
               "aligned_points_rms": similarity_rms(card.points[both], cpu.points[both]),
               "same_log": card.log == cpu.log, "log_diff": log_diff(card.log, cpu.log)}
        tol = SFM_SCALE_CPU_TOL
        check(bool((card.registered == cpu.registered).all()) and out["same_reg_order"]
              and abs(out["mean_px"][0] - out["mean_px"][1]) <= tol["mean_px"]
              and out["aligned_points_rms"] <= tol["aligned_points"], f"sfm_scale small, card vs CPU: {out}")
        return out

    def kernels_line(self):
        line = []
        for name, row in self.kernels.items():
            path = LAUNCH_PATH[name]
            src, rep = SOURCES[name]
            line.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                         "launches": self.launches[path][name], "launches_path": path, "shape": row["shape"],
                         "max_abs_err": row["max_abs_err"], "ms": row["ms"], "kernel_ms": row.get("kernel_ms", row["ms"]),
                         "plain_ms": row["plain_ms"],
                         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                         "library_ms": row["library_ms"], "wall_ms": row["wall_ms"],
                         **{k: row[k] for k in ("cold_ms", "library_cold_ms", "bound_over_cold_ms", "frame_ms",
                                                "frame_library_ms") if k in row}})
        emit({"kernels": line})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU", file=sys.stderr)
        return 2
    smoke = Smoke()
    for phase in (smoke.build, smoke.knn2, smoke.scan, smoke.frontend, smoke.tick, smoke.profile,
                  smoke.reduce_vec, smoke.kinfu, smoke.profile_kinfu, smoke.pyrdown_remap, smoke.dense_flow,
                  smoke.grid_kernels, smoke.photometric, smoke.sfm, smoke.sparse_ba, smoke.sfm_scale):
        phase()
    smoke.kernels_line()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": smoke.name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
