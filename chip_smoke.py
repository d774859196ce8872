#!/usr/bin/env python3
"""Smoke run of the PyTorch port (opencv_contrib_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

It builds the hand-written kernels from opencv_contrib_tpu_torch/ops/cuda/csrc
(first use, a few seconds of nvcc), holds each kernel against its plain
PyTorch version on the card, drives the port's main paths through the entry
points (`entry.frontend`, `entry.keyframe_tick`, `entry.kinfu_track`,
`entry.dense_flow`, `entry.photometric`, the two SfM drivers,
`entry.hash_kinfu_track`, `entry.large_kinfu_track`, `entry.rgbd_odometry`,
`entry.tum_kinfu`, `entry.dynafu_track`, `entry.dryrun_multichip`,
`entry.features_x`, `entry.video_photometric`, `entry.ximgproc_frame`,
`entry.geometry_x`, `entry.track_x`, `entry.stabilize_clip`,
`entry.superres_clip`, `entry.background_x`, `entry.detect_x`,
`entry.recognize_x`, `entry.train_learned`, `entry.learned_x`), and checks
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
      from 5,000 views to 1,500 for time, once, with the counters read
      around it (every count stays 0), held to >= 0.9 of the views, a mean
      reprojection <= 1.4 px, points on >= 0.6 of the tracks and an ATE
      under 0.3 on every 96-view window of the dominant segment; wall s,
      keyframes/s, host ms a span, host syncs, peak memory, and its chunks
      36-43 profiled by step (chunk, windowed BA, re-triangulation, global
      bundle: launches, device ms and host ms each, busy share, top device
      ops; one window of device activity, each step between marker fills);
      the 256 x 1,024 run of tests/test_scale_tpu.py with its gate (host
      syncs and host ms by step); and a noise-free 48 x 48 orbit on the card
      against the CPU with the same RANSAC draws;
  (p) the KinFu remainder at 640x480: `entry.hash_kinfu_track` (HashKinFu,
      3 m / 512 voxels, 16,384 blocks) over orbit_poses(8, 0.5) with the
      counters read around it, the drift gate, the pool and hit-share gates,
      0 host syncs, ms and device ms a tick, stages a tick, peak memory;
      `entry.large_kinfu_track` (96^3 submaps) over the wide orbit with its
      gates, the loop constraint and `optimize_pose_graph`, host syncs a
      frame; `entry.rgbd_odometry` (rgbd, icp, merged) on a textured pair,
      its launches (4 pyrdown, 24 getAb), gates, ms and host syncs a call and
      a profiled call; the colored TSDF at 512^3 (ms, peak memory),
      register_depth, extract_planes, clean_depth (the integral kernel, held
      to its plain version at the padded frame) and the three normals; the
      same paths at 120x160 on the card against the CPU; and a HashKinFu tick
      and a merged odometry with getAb and pyrdown swapped for their plain
      versions;
  (q) the TUM disk path, DynaFu and the dense-flow remainder: 60 frames of
      phase p's orbit at 640x480 with the TUM fr1 intrinsics written as a
      TUM sequence by the port's own PNG codec, then `entry.tum_kinfu`
      (the port's loader, KinFu at 256^3 and 4,096 blocks, the ATE against
      groundtruth.txt) with the counters read around it: the decoded depths
      equal to the written 16-bit quanta, the C++ unfilter equal to the
      numpy version on one PNG of each filter type, ATE < 0.05 m and the
      drift gate; loader frames/s, decode ms a frame, ms a tick from disk
      against from memory, host syncs a tick; `entry.dynafu_track` on the
      growing bump at 480x640 (256^3, 64 nodes, 9 frames): every update ok, the bump
      pulled toward the camera by > 0.05 m, ms a frame and the fit's share;
      `entry.dense_flow` with deepflow, simpleflow, sparse_to_dense, rlof
      and pcaflow on `entry.flow_pair()` with the counters read around
      them: EPE, ms and pyrdown / remap launches a pair, DeepFlow and RLOF
      on the plain path, GPC correspondences and motion templates beside
      them; and each part at its CPU tests' size on the card against the
      CPU;
  (r) the distributed layer on a world-size-1 NCCL mesh in this process;
  (s) the xfeatures2d breadth: knn2 at D = 49, 120 and 200 (512 x 512) and
      the integral kernel at the new tables (edge-padded VGA frames, an
      8-map half-resolution cube, an 8-map VGA stack) against their plain
      versions; `entry.features_x` on `entry.feature_pair()` (480x640, 15
      degrees, K = 512) for every detector and every descriptor with the
      counters read around each, the JAX tests' gates at VGA, GMS and LOGOS,
      TBMR with affine adaptation, PCT with SQFD, template matching in the
      six modes, LINEMOD detect and CCL with component_stats; the same on
      the plain path on integer frames; each part at its CPU tests' size on
      the card against the CPU; ms, device ms, host syncs and launches a
      path;
  (t) video and image IO into the photometric path: the JPEG codec built
      (host C++), its encodes and decodes of a 1080 x 1920 frame at
      qualities 75 and 90 (4:2:0) and of a gray frame held to the digests
      the codec gave where PIL confirmed it bit for bit, and palette, 4-bit
      gray, tRNS and Adam7 PNGs built from raw chunks decoded by both
      routes against their expansions and against the numpy unfilter;
      `entry.video_clip()` (8 x 1080 x 1920) written as Y4M and as MJPG AVI
      into a temporary directory and read back through `VideoReader` onto
      the card (the JAX tests' mean-error gates, frames/s, decode ms a
      frame, `yuv420_to_rgb` on the card against the CPU);
      `entry.video_photometric` on both files with the counters read around
      each (the photometric path's counts and the denoised frames' BRISQUE
      features), ms and device ms a frame, host syncs, peak memory, PSNR
      and the trained BRISQUE scores, each above the clean frame's; the head's
      held-out severity gate, `dct_denoise` and BM3D raising PSNR at 1080 x
      1920, BM3D timed there with its peak memory and equal bits on a
      rerun; each xphoto function and the BRISQUE score at a small size on
      the card against the CPU;
  (u) image structure (ximgproc, HFS, SWT): every method of
      `entry.ximgproc_frame` on `entry.structure_frame()` (480 x 640: the JAX
      tests' fixtures in one frame; graph segmentation and selective search
      on the frame made at 240 x 320), each counted (one grid_transform, the
      gray conversion, and no other kernel of ours), rerun bit-equal, with
      ms, host syncs and peak memory, and one profiler window over all of
      them (device ms, launches, the five costliest kernels); the learned
      edge map trained on the card; the JAX tests' gates at VGA (ED lines
      and circles, Hough, findEllipses, selective search, EdgeBoxes on the
      learned map, SWT, FGS and the WLS filter); the port's CPU run of each
      method against the card's;
  (v) geometry and calibration: every method of `entry.geometry_x` on
      `entry.geometry_scene()` (480 x 640: stereo at 64 disparities, Gray
      code, PSP / FTP / FAPS and the DCT unwrap, reg's five models, ArUco /
      ChArUco, the random pattern, omnidir calibration and undistortion,
      RAPID, PPF with ICP, cloud ICP), each counted (knn2 on the random
      pattern, pyrdown on the reg models, no other kernel of ours), rerun
      bit-equal, with ms, host syncs and peak memory, and one profiler
      window over all of them; the JAX tests' gates at VGA; the port's CPU
      run of each method, in a process of its own, against the card's;
  (w) tracking, videostab and superres: the integral kernel on batches of
      32 x 32 tables (MIL's 337 and Boosting's 489 patches a step) against
      the plain version and single launches; every method of
      `entry.track_x` on `entry.tracking_scene()` (480 x 640, 30 frames:
      MOSSE, KCF, CSRT, DSST, the scaled CSRT / KCF, the Kalman filters,
      MedianFlow, TLD, MIL, Boosting, the MultiTracker, TrackerByMatching,
      the twist, the Siamese tracker trained on the card),
      `entry.stabilize_clip` on `entry.shaky_clip()` and
      `entry.superres_clip()`, each counted (pyrdown, the integral kernel,
      remap as the paths launch them, no other kernel of ours), rerun
      bit-equal, with ms a frame, host syncs and peak memory, and one
      profiler window over all of them on the clips' first frames; the JAX
      tests' gates at VGA; the port's CPU run of each path, in a process of
      its own, against the card's;
  (x) background subtraction and the retina, detection, shape and face: the
      integral kernel on WaldBoost's 8 x 480 x 640 channel stack (one
      launch, bit-equal to 8 single launches and, on integer channels, to
      the plain version; timed beside the plain version and two cumsums);
      every method of `entry.background_x` on `entry.background_clip()`
      (MOG, CNT, GMG, GSOC, LSBP, the retina with the transient
      segmentation, the color retina and tone mapping) and of
      `entry.detect_x` on `entry.detection_scene()` (HOG, WaldBoost, DPM,
      EigenFaces, FisherFaces, LBPH, BIF, AAM, Facemark, shape context,
      TPS, the EMDs, the affine transformer), each JAX test's fixture laid
      into 480 x 640 frames, each counted (the integral kernel once a
      WaldBoost detection and three times a transient step, no other kernel
      of ours), rerun bit-equal, with ms a frame, host syncs and peak
      memory, and one profiler window over all of them; the JAX tests'
      gates at VGA; the port's CPU run of each method, in a process of its
      own, against the card's;
  (y) hashes, saliency, lines and MIH, the colour chart, the ER filter, OCR
      and QR: every method of `entry.recognize_x` at VGA, the same way;
  (z) the learned models trained in the repo and signal / fuzzy / alphamat
      / plot: the seven `entry.train_learned` recipes on the card (the JAX
      tests' draws and step counts), counted (the SR evaluations' quality
      kernels), timed, their host syncs, the tests' gates on their
      readings; every method of `entry.learned_x` on
      `entry.learned_scene()` at VGA, counted, rerun bit-equal, timed, one
      profiler window, the tests' gates; the port's CPU run of each method
      at 120 x 160 with the card's weights against the card's.
Then one `kernels` JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Any failed check raises: the script
then exits non-zero and prints no last line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import zlib
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
# phase p's paths: their counts go in the kernels line beside those of the paths above (launches_by_path)
PATH_KERNELS.update({"hash_kinfu": ("grid_reduce_vec",), "large_kinfu": ("grid_reduce_vec",),
                     "odometry": ("grid_reduce_vec", "pyrdown"), "odometry_icp": ("grid_reduce_vec", "pyrdown"),
                     "odometry_rgbd": ("pyrdown",), "clean_depth": ("integral_image",)})
# phase q's paths: KinFu from disk (getAb; its depth pyramid is no pyrdown), DynaFu (no kernel of ours), and the
# dense-flow remainder (pyrdown in every pyramid, remap in the variational refinement of DeepFlow and RLOF)
PATH_KERNELS.update({"tum_kinfu": ("grid_reduce_vec",), "dynafu": (), "dense_flow_extra": ("pyrdown", "remap")})
# phase r's paths: the dist_sfm step's frontend (the integral kernel) and the stage pipeline's detect and match
# stages (the integral kernel; knn2 through ratio_test_match); the BA, submap and checkpoint paths launch none
PATH_KERNELS.update({"dist_dense_ba": (), "dist_sparse_ba": (), "dist_global_ba": (),
                     "dist_sfm_step": ("integral_image",), "dist_submaps": (),
                     "dist_stage_pipeline": ("integral_image", "knn2"), "dist_checkpoint": (),
                     "dryrun_multichip": ()})
# phase s's paths: features_x with each detector (SURF descriptors, matched by knn2; Star's box maps and
# Harris-Laplace's blurs and orientation read summed-area tables) and each descriptor (on Fast-Hessian, whose table
# is the integral kernel's; float descriptors matched by knn2, binary ones by the Hamming product), and the rest
PATH_KERNELS.update({"xfeat_star": ("integral_image", "knn2"), "xfeat_msd": ("knn2",),
                     "xfeat_harris_laplace": ("integral_image", "knn2"), "xfeat_harris": ("knn2",),
                     "xfeat_fast": ("knn2",), "xfeat_daisy": ("integral_image", "knn2"),
                     "xfeat_brief": ("integral_image",), "xfeat_boxes": ("integral_image",),
                     "xfeat_freak": ("integral_image",), "xfeat_latch": ("integral_image",),
                     "xfeat_lucid": ("integral_image", "knn2"), "xfeat_vgg": ("integral_image", "knn2"),
                     "xfeat_boostdesc": ("integral_image",), "xfeat_gms_logos": (), "xfeat_tbmr": (),
                     "xfeat_pct": (), "xfeat_template": ("integral_image",), "xfeat_linemod": (), "xfeat_ccl": ()})
DEVICE_KERNELS = ("knn2_kernel", "scan_rows_kernel", "integral_kernel", "integral_table_kernel",
                  "grid_reduce_vec_kernel", "pyrdown_kernel",
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
# ahead of its markers a window launches N_LEAD int8 fills (LEAD_KERNEL), left out of every count: a late trace
# drops one or two of its first kernel events in nearly every window (162 windows lost a uint8 marker that way in a
# whole run), so the markers that follow the lead are the ones that must all survive
LEAD_KERNEL = "FillFunctor<signed char>"
N_LEAD = 8
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
# sfm_scale_run.py's configuration is 5,000 views x 1,024 slots with its settings; the script runs it cut to 1,500
# views (slots, noise and settings uncut; by that script's rule tracks live max(24, V // 125) = 24 views and min_gap is
# max(3, 24 // 3) = 8): the 5,000 took 546.5 s on the card's host, and 2,500 views 381 s of a 799 s script on a slow
# host, past half the script's 1,200 s limit (PERF.md §4). 1,000 views is no cut of depth alone: the scene's ring
# then turns faster a view, its first 96-view window's ATE read 0.393 against the 0.3 gate on the H100, and the run
# took 147 s, no less than 1,500 views had (PERF.md §4). Gates: tests/test_sfm_scale.py's (>= 0.9 of the views, points on >= 0.6 of the tracks), the
# reference's 1.4 px mean reprojection (test_simple_pipeline.cpp:82), and tests/test_sfm_scale.py:57-60's ATE < 0.3
# (similarity-aligned camera centres, ring radius 4) at that test's own scale: on every 96-view window of the dominant
# segment. Over the whole segment the reference drifts past it: the JAX package's dominant segment at 2,500 views
# has an ATE of 2.485 (scripts/sfm_scale_ate.py; ROADMAP Queue 3), so that ATE is reported, not gated
SFM_SCALE = (1500, 1024)
SFM_SCALE_RUN = dict(window=24, ba_every=4, min_gap=max(3, max(24, SFM_SCALE[0] // 125) // 3), min_parallax_deg=0.4,
                     final_global_iters=15)
SFM_SCALE_MIN_VIEW_SHARE, SFM_SCALE_MIN_POINT_SHARE, SFM_SCALE_ATE, SFM_SCALE_ATE_WINDOW = 0.9, 0.6, 0.3, 96
# the profiled run: tests/test_scale_tpu.py::test_sfm_scale_256_end_to_end (256 x 1,024, span 24; >= 250 views)
SFM_SCALE_256 = (256, 1024)
SFM_SCALE_256_RUN = dict(window=24, ba_every=4, min_gap=3, final_global_iters=15)
SFM_SCALE_256_MIN_VIEWS = 250
# the main run's profiled chunks (the 256 run's once, where they held views 145-176 and a growth-triggered global
# bundle)
SFM_SCALE_CHUNK_WINDOW = (36, 44)
# card against CPU with the same draws on a noise-free 48 x 48 orbit (tests/test_torch_sfm_scale.py's settings; on
# noisy pixels f32 rounding, amplified by near-parallel triangulation, decides points at the 4 px gate where the
# ring closes, so two correct runs part there: ROADMAP Queue 3): the same registered views and reg_order, mean
# reprojection within 1e-3 px, points within 1e-3 RMS after a similarity alignment
SFM_SCALE_SMALL = dict(n_views=48, slots_per_view=48, track_span=10, seed=1, noise_px=0.0)
SFM_SCALE_SMALL_RUN = dict(window=12, ba_every=3, min_gap=2)
SCALE_SIDE_TIMEOUT_S = 600  # phase o's side runs, which end during its main run (~50 s of its ~200)
SFM_SCALE_CPU_TOL = {"mean_px": 1e-3, "aligned_points": 1e-3}
SCALE_PREFIX = "sfm_scale."  # the 5k driver's spans (its own: sequential, global_ba)
# the script's spans around the driver's device steps (module functions the driver looks up at each call)
SCALE_STEPS = {"_chunk_register_jit": "chunk", "_windowed_ba_jit": "windowed_ba", "_retriangulate": "retriangulate",
               "_global_ba_jit": "global_bundle"}

# phase p, the KinFu remainder at VGA: 640x480 frames of the reference orbit rendered on the card with the
# intrinsics (400, 400, 320, 240). HashKinFu: orbit_poses(8, sweep=0.5), 3 m / 512 voxels (the VGA / 512^3 KinFu's
# voxel), 16,384 blocks (HashKinFu's default), the reference's drift gate (test_kinfu.cpp:326-330), no block evicted,
# and the last raycast hitting >= 0.75 of the pixels with depth (the JAX package hits 0.83 on frame 0). LargeKinFu:
# tests/test_rgbd_scale.py:67-80's wide orbit (10 frames, sweep 1.2, max_dist_from_center 0.35) with the 96^3 / 3 m
# submaps of LargeKinFuParams, its drift gate, and :96-101's loop constraint. Odometry: tests/test_rgbd.py:197-210's
# textured pair (frames 0 and 1) and its gate for icp and merged. The colored TSDF at 512^3 over 3.2 m (the
# reference ColoredKinFu's dims), two frames with a seeded texture
RGBD_SHAPE = (480, 640)
RGBD_INTR = [400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0, 0]
HASH_VOXEL, HASH_CAPACITY, HASH_HIT_SHARE = 3.0 / 512, 16384, 0.75
KINFU_DRIFT = (0.02, 0.1)  # rad, m
LARGE_ORBIT, LARGE_PARAMS, LARGE_DRIFT = (10, 1.2), dict(max_dist_from_center=0.35), (0.05, 0.15)
ODO_METHODS, ODO_GATE, N_ODO_TIMED = ("rgbd", "icp", "merged"), (0.015, 0.03), 3
ODO_LAUNCHES = {"rgbd": {"pyrdown": 4, "grid_reduce_vec": 0}, "icp": {"pyrdown": 4, "grid_reduce_vec": 24},
                "merged": {"pyrdown": 4, "grid_reduce_vec": 24}}  # 2 gray pyramids of 3 levels; 7 + 7 + 10 steps
COLORED_RES, COLORED_SIZE = (512, 512, 512), 3.2
HASH_STAGES = {"make_frame", "icp", "allocate", "integrate", "raycast"}  # HashKinFu.update's record_function ranges
N_HASH_TIMED, N_HASH_PROFILED = 6, 2
# the card against the CPU at tests/test_rgbd.py's 120x160 (intrinsics 120, 120, 80, 60): the CPU tests'
# tolerances, with the allowances widened where the card's summation order shows (getAb, cuBLAS, the integral kernel)
RGBD_SMALL_SHAPE = (120, 160)
RGBD_SMALL_INTR = [120.0, 120.0, 80.0, 60.0, 0, 0, 0, 0, 0]
RGBD_CPU_TOL = {"hash_pose": 1e-4, "blocks": 1e-3, "large_pose": 2e-3, "odometry_T": 1e-4, "colors": 1e-5,
                "voxel_share": 1e-3, "pixel_share": 1e-3, "plane": 1e-4, "clean_depth": 1e-5, "normals": 1e-4}
RGBD_PLAIN_TOL = 1e-4  # a HashKinFu tick's pose and a merged odometry's T, kernel path against plain path

# phase q, the TUM disk path, DynaFu and the dense-flow remainder. TUM: phase p's orbit (sweep 0.5) sampled at 60
# frames, rendered at 640x480 with the TUM fr1 intrinsics and written as a TUM sequence; KinFu with
# tests/test_tum_e2e.py::test_real_fr1_ate's 256^3 and 4,096 blocks over 3.2 m centred at (0, 0, 2.2) (the orbit's
# scene, tests/test_rgbd.py's, lies inside: the sphere and the wall at 1.5-3.3 m), its ATE gate and the reference
# drift gate. DynaFu: tests/test_rgbd_extras.py:154-185's growing bump at 480x640 (intrinsics x 8), 256^3 over 2 m,
# 64 nodes, the bump's growth to 0.2 m sampled at 9 frames, not the test's 5: at 256^3 the truncation band (5 voxels,
# 3.9 cm) is narrower than the test's 5 cm growth a frame, and the reference itself then misses its own 0.05 m gate:
# the JAX package reaches 0.0391 m at 480x640 with 5 frames and 0.0593 with 9 (2.5 cm a frame; on the CPU,
# scripts/dynafu_bump.py). Flow: the five new dense_flow methods on entry.flow_pair() (436x1024), GPC and motion templates beside
# them. Card against CPU at the CPU tests' sizes.
TUM_FRAMES, TUM_SWEEP, TUM_SHAPE = 60, 0.5, (480, 640)
TUM_FR1_INTR = [517.3, 516.5, 318.6, 255.3, 0, 0, 0, 0, 0]  # utils/datasets.py's TUM_FR1_INTR
TUM_KINFU = dict(volume_resolution=(256, 256, 256), volume_size=3.2, volume_center=(0.0, 0.0, 2.2), sparse_blocks=4096)
TUM_ATE_GATE = 0.05  # m, tests/test_tum_e2e.py:114
TUM_MINI = dict(n=6, sweep=0.4, shape=(120, 160), intr=[120.0, 120.0, 80.0, 60.0, 0, 0, 0, 0, 0],
                kinfu=dict(volume_resolution=(96, 96, 96), volume_size=3.2, volume_center=(0.0, 0.0, 2.2),
                           sparse_blocks=512))  # tests/test_tum_e2e.py's mini sequence
DYNAFU_SHAPE, DYNAFU_SCALE, DYNAFU_FRAMES, DYNAFU_SMALL_FRAMES = (480, 640), 8, 9, 5
DYNAFU_PARAMS = dict(volume_resolution=(256, 256, 256), volume_size=2.0, volume_center=(0.0, 0.0, 1.2), n_nodes=64,
                     node_sigma=0.3)
DYNAFU_SMALL = dict(volume_resolution=(64, 64, 64), volume_size=2.0, volume_center=(0.0, 0.0, 1.2), n_nodes=32,
                    node_sigma=0.3)  # tests/test_rgbd_extras.py:167-169
DYNAFU_BUMP_GATE = 0.05  # m, the rim minus the centre of the live render (tests/test_rgbd_extras.py:185)
FLOW_EXTRA = ("deepflow", "simpleflow", "sparse_to_dense", "rlof", "pcaflow")
FLOW_EXTRA_EPE_GATE = 1.0  # px, interior EPE: a sanity gate (0.08-0.33 px on the CPU at this size)
FLOW_EXTRA_SMALL = (64, 96)  # tests/test_torch_flow_extra.py's size
N_FLOW_EXTRA_TIMED = 3
# pyrdown: levels - 1 a pyramid, two pyramids a pyramidal solve (sparse_to_dense tracks twice); remap: one a
# fixed-point iteration of dis.variational_refine (DeepFlow 5 levels x 5, dense RLOF's post-pass 3)
FLOW_EXTRA_LAUNCHES = {"deepflow": {"pyrdown": 8, "remap": 25}, "simpleflow": {"pyrdown": 4, "remap": 0},
                       "sparse_to_dense": {"pyrdown": 8, "remap": 0}, "rlof": {"pyrdown": 4, "remap": 3},
                       "pcaflow": {"pyrdown": 4, "remap": 0}}
# flow: at most 1e-3 of the pixels past FLOW_CPU_TOL (cuBLAS resizes the coarse flow in another summation order,
# and an ulp can move SimpleFlow's integer winner at a tie)
# phase r: the distributed layer on a world-size-1 NCCL mesh, each path against its single-device twin
DIST_REL_TOL = 1e-6  # relative: NCCL's all_reduce of one rank is a copy
DIST_SFM_FRAMES = 32  # entry.make_frames(32)'s first 32 frames: a (32, 32, 512, 512) distance block, 1.07 GB
DIST_SUBMAPS = (16, 4096)  # submaps x boundary points
DIST_SUBMAP_ITERS = 25  # tests/test_parallel.py's steps
DIST_STAGE_FRAMES = 8
DIST_VOLUME = (256, 256, 256)
DIST_PREFIX = "ncclDevKernel"  # NCCL's device kernels in the profiler's raw events
# a profiler window drops its first device events, more the more windows the process has opened (phase r's
# checkpoint lost all 20 of its copies behind 8 markers): open each with 256 marker fills, and again if none stayed
DIST_MARKERS, DIST_WINDOWS = 256, 3
REMAINDER_CPU_TOL = {"tum_pose": 1e-3, "tum_ate": 1e-3, "dynafu_xi": 1e-3, "dynafu_render": 1e-3,
                     "flow": FLOW_CPU_TOL, "flow_share": 1e-3, "gpc_tie_share": 0.01, "motempl_deg": 1e-3}
XFEAT_SHAPE, XFEAT_K = (480, 640), 512  # entry.feature_pair()'s VGA pair, K = 512
XFEAT_DETECTORS = ("star", "msd", "harris_laplace", "harris", "fast")  # each with SURF descriptors
XFEAT_DESCRIPTORS = ("daisy", "brief", "boxes", "freak", "latch", "lucid", "vgg", "boostdesc")  # on Fast-Hessian
# tests/test_features_x.py's rotation gates: matches > n and inlier share > rate (3 px under the known rotation)
XFEAT_GATES = {"freak": (20, 0.6), "latch": (20, 0.8), "vgg": (20, 0.8), "boostdesc": (15, 0.7)}
XFEAT_KNN2_WIDTHS = (49, 120, 200)  # LUCID, VGG (the default projection), DAISY; Q = T = XFEAT_K
XFEAT_PAD_RADII = (3, 4, 8)  # the box passes' edge pads: FREAK's sigma 3.6 / 4.2, Harris-Laplace's sigma 7.6
XFEAT_CUBE = (8, 240, 320)  # a half-resolution 8-map cube (DAISY's cubes of sigma >= 5 are smoothed at this size)
XFEAT_EXACT_LEVELS = 50  # integer frames 0..50: an edge-padded VGA table (r <= 8) stays below 2**24
XFEAT_SMALL = (96, 128)  # tests/test_torch_features_x.py's chain size
XFEAT_TM_CUT = (200, 300, 64)  # template matching: a 64x64 cut of frame 1 at (200, 300)
XFEAT_LINEMOD_AT = (250, 330)  # the L object of tests/test_rgbd_extras.py placed in a VGA scene
XFEAT_PREFIX = "xfeat."  # phase s's record_function spans, one a timed call
XFEAT_REPS = 10  # calls a kernel span times
XFEAT_PLAIN_TOL = {"kp_equal": 0.98, "valid_agree": 0.95, "bits_agree": 0.99, "float_desc": 1e-3,
                   "surface_rel": 1e-3}
XFEAT_CPU_TOL = {"kp_equal": 0.98, "valid_agree": 0.95, "bits_agree": 0.99, "float_desc": 1e-3, "tbmr_px": 1e-2,
                 "pct": 1e-4, "surface_rel": 1e-4, "linemod_score": 1e-5}

# phase t: video and image IO into the photometric path. The codec's fixtures: an integer-pattern 1080 x 1920 frame
# (`codec_frame`) encoded at PIL's qualities 75 (utils/io.imwrite) and 90 (the MJPG writer), 4:2:0, and its gray at
# 75; each (sha256 of the bytes, sha256 of the decoded samples, bytes) as the codec gave them where PIL's encode and
# decode of the same frame were equal to them bit for bit (tests/test_torch_codec.py holds the codec to PIL)
JPEG_DIGESTS = {
    "rgb_q75": ("1c0682c19e6343281dcde2da593635c0d53ce009c7d8888f21254d0c52cc4aad",
                "1d98bcd51826c7c897bc9b74112ce6a1de39d54f3e70347de4ce694588476d2d", 936350),
    "rgb_q90": ("05c13849a66d7f0c906bbe4426faa724d7a60d348cdb3db29417e91112d262de",
                "462c4f1f8e465996a98613ee024cc6248ec749008a933182be7cd9190d986185", 1502079),
    "gray_q75": ("d116eeab2d47e2c541671ea79afe4c828b182fd907baf3c18d491878fcd25906",
                 "4869e14ee4bfcdc68944235f4da28ac24d5f5af9c83fd527a77736d264edb48e", 687794)}
VIDEO_CLIP = PHOTO_CLIP  # entry.video_clip()'s defaults: photo_clip()'s 8 x 1080 x 1920
VIDEO_CODECS = {"y4m": "video_photometric_y4m", "MJPG": "video_photometric_mjpg"}  # codec -> counted path
VIDEO_MEAN_ERR = {"y4m": 0.03, "MJPG": 0.08}  # tests/test_io_modules.py:172, :201: the clip read back vs written
N_VIDEO_TIMED = 2
VIDEO_PREFIX = "video."  # names no span: the video path is profiled whole
VIDEO_SMALL = (2, 64, 96)  # the card against the CPU: tests/test_torch_xphoto.py's sizes
VIDEO_NOISE = {"dct": 0.05, "bm3d": 0.08}  # tests/test_imgproc_modules.py:29, tests/test_breadth5.py:9-22
VIDEO_CPU_TOL = {"dct": 1e-5, "inpaint": 1e-6, "oil_share_off": 0.01, "wb": 1e-5, "bm3d": 1e-5, "brisque": 0.5,
                 "yuv": 1e-6}
# the video path launches what entry.photometric does: gamma once a batch of 8, and PHOTO_PER_FRAME a frame
# (xphoto.dct_denoise is matrix products), plus the BRISQUE features of the denoised frame that the head scores
BRISQUE_PER_FRAME = {"grid_transform": 10, "grid_reduce": 10}
VIDEO_PER_FRAME = {k: n + BRISQUE_PER_FRAME.get(k, 0) for k, n in PHOTO_PER_FRAME.items()}
PATH_KERNELS.update({path: PATH_KERNELS["photometric"] for path in VIDEO_CODECS.values()})


XIMG_SHAPE = (480, 640)  # entry.structure_frame()'s VGA frame
XIMG_MARKER = "FillFunctor<short>"  # the int16 fills that part phase u's calls in its profile
CLOSE_MARKER = "FillFunctor<c10::complex<float>"  # phase o's chunk window closes each step with a complex64 fill
# the host union-find of graph segmentation and selective search takes ~8 s a call at VGA on a host core (PERF.md
# section 4): they run on the same frame made at half the size
XIMG_CUT = {"graph_segment": (240, 320), "selective_search": (240, 320)}
# the methods that answer label maps: a rerun on the card must give their bits again
XIMG_LABELS = {"slic", "seeds", "lsc", "scan_segment", "hfs_segment", "graph_segment", "region_features",
               "region_adjacency", "canny", "thinning", "niblack_threshold", "stroke_width_map"}
# the learned edge map's training held card against CPU: both from init_params(seed 0) on the default scenes' first
# XIMG_TRAIN["n_images"], for XIMG_TRAIN["steps"] Adam steps (the default model's 400 steps on 40 scenes take
# minutes on the host); the parameters by their largest difference, the VGA frame's maps by theirs
XIMG_TRAIN = {"n_images": 8, "steps": 20}
XIMG_TRAIN_TOL = {"params": 2e-5, "map": 1e-6}  # readings 3.2e-6 and 1.5e-7 on the H100 (PERF.md section 6)
# the card against the port's CPU run: float maps by their largest difference over the CPU's range; masks and label
# maps by the share of pixels that differ (the card's one-hot sums and the CPU's ordered sums round apart, which
# can flip a near-tie); host arrays (boxes, lines, circles) by shape and largest difference (px)
XIMG_CPU_TOL = {"default": {"rel": 1e-4, "px_off": 1e-3, "mask_off": 1e-3, "labels_off": 2e-3, "shape_off": 0.0,
                             "host_abs": 0.5},
                # second differences of a blurred frame: the blur's taps (exp on each device) part by an ulp, which
                # the Hessian amplifies (1.2e-3 of the range on the H100)
                "ridge_filter": {"rel": 1e-2},
                # the NMS and the Hough bins: a near-tie flips a pixel or moves a vote to the next bin (the largest
                # difference is then a whole value: 5.3e-3 and 2.9e-3 of the range on the H100)
                "structured_edges_lite": {"rel": 2e-2}, "fast_hough_lines": {"rel": 2e-2},
                # the centres move with the labels that flip at near-ties: one centre of SLIC's 16 (2 of 32
                # entries) and of LSC's 64 (9 of 640 entries), by 1.8e-4 and 2.9e-4 of the range on the
                # H100; at most two centres may move, by at most 2e-3 of the range
                "slic": {"rel": 2e-3, "px_off": 4 / 32}, "lsc": {"rel": 2e-3, "px_off": 20 / 640}}


XIMG_CPU_THREADS = 4  # the CPU run's torch threads (a process of its own, beside the card's runs)


def ximg_cpu_outputs(params: dict, threads: int) -> dict:
    """Every entry.ximgproc_frame method on the CPU, on entry.structure_frame()
    at its shape (XIMG_SHAPE, or XIMG_CUT), with the learned edge map's
    model `params` (numpy: the card's, trained before), its tensors as
    numpy (phase u's CPU run, in a process of its own)."""
    import torch

    from opencv_contrib_tpu_torch import entry
    from opencv_contrib_tpu_torch.ximgproc import edge_forest

    torch.set_num_threads(threads)
    edge_forest._DEFAULT_PARAMS["cpu"] = {k: torch.from_numpy(v) for k, v in params.items()}
    frames = {shape: entry.structure_frame(*shape) for shape in {XIMG_SHAPE, *XIMG_CUT.values()}}
    out = {}
    for m in entry.METHODS:
        f = frames[XIMG_CUT.get(m, XIMG_SHAPE)]
        got = entry.ximgproc_frame(f.rgb, m, device="cpu", disparity=f.disparity)
        leaves = list(got) if isinstance(got, tuple) else [got]
        out[m] = [x.numpy() if isinstance(x, torch.Tensor) else x for x in leaves]
    return out


# phase v: entry.geometry_x's methods (entry.GEOMETRY, checked) at VGA; the random pattern matches by knn2, the reg
# models build their pyramids by pyrdown (levels - 1 launches an image); the rest launch no kernel of ours
GEO_SHAPE = (480, 640)  # entry.geometry_scene()'s frame
GEO_REG = ("shift", "euclidean", "similarity", "affine", "projective")
GEO_METHODS = ("block_match", "sgm_match", "quasi_dense_stereo", "lr_consistency", "graycode", "psp", "ftp", "faps",
               "unwrap_phase_dct", *(f"reg_{m}" for m in GEO_REG), "detect_markers", "interpolate_charuco_corners",
               "estimate_pose_single_markers", "find_correspondences", "calibrate_omni", "calibrate_omni_fix_xi",
               "undistort_image_omni", "rapid_track", "ppf", "cloud_icp")
GEO_LAUNCHES = {"find_correspondences": {"knn2": 2}, **{f"reg_{m}": {"pyrdown": 4} for m in GEO_REG}}
PATH_KERNELS.update({f"geometry_{m}": tuple(GEO_LAUNCHES.get(m, {})) for m in GEO_METHODS})
GEO_CPU_THREADS = 4  # the CPU run's torch threads (a process of its own, beside the card's runs)
# the card against the port's CPU run (geometry_diff): the stereo maps by the share of pixels that differ
# (`off`), phases through angle(exp(i (a - b))) in rad, the unwrap and the omni undistortion by their largest
# difference over their range (the undistortion's sample coordinates, ~600 px, round apart by ~1e-7 of them, which
# the random pattern's slopes of up to ~0.3 a pixel carry into the samples: 1.2e-5 of the range on the H100,
# PERF.md section 6; the bound is phase u's for float maps), the parameters, points and poses by their largest difference
GEO_CPU_TOL = {"disparity_off": 5e-3, "phase_rad": 1e-4, "unwrap_rel": 2e-4, "reg_abs": 1e-4, "corner_px": 1e-3,
               "pose_abs": 1e-4, "points_px": 1e-3, "omni_px": 0.01, "omni_rms_rel": 1e-4, "image_rel": 1e-4,
               "ppf_pose_abs": 1e-4, "icp_err_abs": 1e-6}


# ---- phase v: geometry and calibration ---------------------------------------------------------------------------


def _geo_host(x):
    """A result of a phase-v or -w path with its tensors as numpy (tuples,
    lists kept; dicts and NamedTuples as dicts)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        x = x._asdict()
    if isinstance(x, dict):
        return {k: _geo_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_geo_host(v) for v in x)
    return x


def _geo_equal(a, b) -> bool:
    """Two results of one path hold the same bits."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        a, b = a._asdict(), b._asdict()
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_geo_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_geo_equal(u, v) for u, v in zip(a, b))
    if hasattr(a, "detach"):
        import torch

        return bool(torch.equal(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and a.dtype == b.dtype and bool(np.array_equal(a, b))
    return a == b


def _same_draws(robust, torch):
    """robust.sample_indices drawing from one CPU generator of seed 0, moved
    to the data's device: the card and the CPU see the same samples
    wherever they hold the same state."""
    draw, gen = robust.sample_indices, torch.Generator().manual_seed(0)

    def same(generator, n_points, mask, n_hypotheses, sample_size):
        return draw(gen, n_points, mask.cpu(), n_hypotheses, sample_size).to(mask.device)

    return mock.patch.object(robust, "sample_indices", same)


def geometry_cpu_outputs(shape, threads: int) -> dict:
    """Every entry.geometry_x method on entry.geometry_scene(*shape) on the
    CPU, as numpy (phase v's CPU run, in a process of its own); the random
    pattern on `_same_draws`."""
    import torch

    from opencv_contrib_tpu_torch import entry
    from opencv_contrib_tpu_torch.mvg import robust

    torch.set_num_threads(threads)
    scene = entry.geometry_scene(*shape)
    out = {}
    for m in GEO_METHODS:
        if m == "find_correspondences":
            with _same_draws(robust, torch):
                out[m] = _geo_host(entry.geometry_x(scene, m, device="cpu"))
        else:
            out[m] = _geo_host(entry.geometry_x(scene, m, device="cpu"))
    return out


def _wrapped(a, b) -> float:
    return float(np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - b)))).max())


def _omni_reprojected(res, scene):
    """calibrate_omni's result reprojected: the board through every view's
    pose and the calibrated K and xi (numpy, float64)."""
    K, xi, Rs, ts, _ = res
    out = []
    for obj, R, t in zip(scene.omni_obj, Rs, ts):
        Xc = obj.astype(np.float64) @ np.asarray(R, np.float64).T + t
        s = Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)
        d = s[:, 2] + xi
        out.append(np.stack([K[0, 0] * s[:, 0] / d + K[0, 2], K[1, 1] * s[:, 1] / d + K[1, 2]], -1))
    return np.stack(out)


def geometry_diff(method: str, card, host, scene) -> dict:
    """How the card's result of one method (numpy, `_geo_host`) parts from
    the CPU's, in the terms of GEO_CPU_TOL; returns the readings, each
    beside its bound, and whether all hold."""
    tol = GEO_CPU_TOL
    r = {}
    if method in ("block_match", "sgm_match", "quasi_dense_stereo", "lr_consistency"):
        for i, (u, v) in enumerate(zip(card, host)):
            r[f"off_{i}"] = (float((np.abs(u.astype(np.float64) - v) > 1e-3).mean()), tol["disparity_off"])
    elif method == "graycode":
        r["differ"] = (float(sum((u != v).mean() for u, v in zip(card, host))), 0.0)
    elif method in ("psp", "ftp", "faps"):
        u, v = (card[0], host[0]) if method == "psp" else (card, host)
        r["rad"] = (_wrapped(u, v), tol["phase_rad"])
        if method == "psp":
            r["amp_abs"] = (float(np.abs(card[1] - host[1]).max()), 1e-5)
    elif method == "unwrap_phase_dct":
        r["rel"] = (float(np.abs((card - card.mean()) - (host - host.mean())).max() / np.ptp(host)), tol["unwrap_rel"])
    elif method.startswith("reg_"):
        r["abs"] = (float(np.abs(card - host).max()), tol["reg_abs"])
    elif method == "detect_markers":
        r["ids_differ"] = (float(card[0] != host[0]), 0.0)
        r["corner_px"] = (max((float(np.abs(u - v).max()) for u, v in zip(card[1], host[1])), default=0.0),
                          tol["corner_px"])
    elif method == "interpolate_charuco_corners":
        r["ids_differ"] = (float(card[0] != host[0]), 0.0)
        r["corner_px"] = (float(np.abs(card[1] - host[1]).max()), tol["corner_px"])
    elif method == "estimate_pose_single_markers":
        r["ids_differ"] = (float(card[0] != host[0]), 0.0)
        r["pose_abs"] = (max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                             for p, q in zip(card[1], host[1]) for a, b in zip(p, q)), tol["pose_abs"])
    elif method == "find_correspondences":
        r["n_differ"] = (float(card[2] != host[2]), 0.0)
        r["points_px"] = (float(np.abs(card[1] - host[1]).max()) if card[2] == host[2] else float("inf"),
                          tol["points_px"])
    elif method.startswith("calibrate_omni"):
        r["reproj_px"] = (float(np.abs(_omni_reprojected(card, scene) - _omni_reprojected(host, scene)).max()),
                          tol["omni_px"])
        r["rms_rel"] = (abs(card[4] - host[4]) / host[4], tol["omni_rms_rel"])
    elif method == "undistort_image_omni":
        r["rel"] = (float(np.abs(card - host).max() / np.ptp(host)), tol["image_rel"])
    elif method == "rapid_track":
        r["pose_abs"] = (max(float(np.abs(card[0] - host[0]).max()), float(np.abs(card[1] - host[1]).max())),
                         tol["pose_abs"])
    elif method == "ppf":
        r["refined_abs"] = (float(np.abs(card[2] - host[2]).max()), tol["ppf_pose_abs"])
        r["votes"] = ([float(card[1]), float(host[1])], None)
    elif method == "cloud_icp":
        r["pose_abs"] = (float(np.abs(card[0] - host[0]).max()), tol["ppf_pose_abs"])
        r["err_abs"] = (abs(card[1] - host[1]), tol["icp_err_abs"])
    ok = all(bound is None or val <= bound for val, bound in r.values())
    return {"ok": ok, **{k: v[0] for k, v in r.items()}}


def geometry_gates(scene, outs: dict) -> dict:
    """The JAX tests' gates, brought to the scene's size, on each result in
    `outs` (method -> geometry_x's result on `scene`); raises, naming every
    miss, after checking all. Returns the gated numbers."""
    import torch

    from opencv_contrib_tpu_torch import entry, reg
    from opencv_contrib_tpu_torch.core import se3

    H, W = scene.left.shape
    gt = scene.disparity
    # stereo: away from the box's disparity edges (8 px) and the columns whose right match rolls around
    edge = np.zeros((H, W), bool)
    y0, x0, y1, x1 = scene.stereo_box
    edge[max(y0 - 8, 0):y1 + 9, max(x0 - 8 - entry.GEO_STEREO_DISP[1], 0):x1 + 9] = True
    interior = np.zeros((H, W), bool)
    interior[8:-8, 64 + 16:-16] = True
    far = interior & ~edge
    g, missed = {}, {}

    def host(x):
        return _geo_host(x)

    for m, out in outs.items():
        o = host(out)
        if m == "block_match":  # tests/test_bgsegm_stereo.py::test_block_match_constant_disparity
            d, v = o
            g[m] = {"valid": float(v[far].mean()), "err_px": float(np.abs(d[far & v] - gt[far & v]).mean())}
            ok = g[m]["valid"] > 0.6 and g[m]["err_px"] < 0.5
        elif m == "sgm_match":  # test_sgm_constant_disparity
            g[m] = {"err_px": float(np.abs(o[0][far] - gt[far]).mean())}
            ok = g[m]["err_px"] < 0.6
        elif m == "quasi_dense_stereo":  # tests/test_breadth5.py::TestQuasiDense
            d, v = o
            inner = np.zeros((H, W), bool)
            inner[4:-4, 64 + 12:-4] = True
            g[m] = {"cover": float((v & inner).sum() / inner.sum()),
                    "good": float((np.abs(d[v & far] - gt[v & far]) <= 1.0).mean())}
            ok = g[m]["cover"] > 0.8 and g[m]["good"] > 0.9
        elif m == "lr_consistency":  # test_lr_consistency: the block-matched pair consistent away from edges
            g[m] = {"consistent": float(o[2][far].mean())}
            ok = g[m]["consistent"] > 0.9
        elif m == "graycode":  # tests/test_breadth2.py's decode tests: col x, row y
            col, row, valid = o
            ok = (np.array_equal(col, np.broadcast_to(np.arange(W), (H, W)))
                  and np.array_equal(row, np.broadcast_to(np.arange(H)[:, None], (H, W))) and bool(valid.all()))
            g[m] = {"exact": ok}
        elif m == "psp":  # test_psp_phase_recovery
            expected = 2 * np.pi * 40 * np.arange(W) / W
            g[m] = {"err_rad": _wrapped(o[0], expected[None]), "amp_min": float(o[1].min())}
            ok = g[m]["err_rad"] < 0.05 and g[m]["amp_min"] > 0.4
        elif m in ("ftp", "faps", "unwrap_phase_dct"):  # TestSinusoidalFtpFaps; TestPhaseUnwrapping
            d = (o + scene.fringe_true)[12:-12, 12:-12]
            if m == "unwrap_phase_dct":
                g[m] = {"std": float(d.std())}
                ok = g[m]["std"] < 0.05
            else:
                d = np.angle(np.exp(1j * d))
                g[m] = {"err_rad": float(np.abs(np.angle(np.exp(1j * (d - np.median(d))))).mean())}
                ok = g[m]["err_rad"] < 0.05
        elif m.startswith("reg_"):  # tests/test_imgproc_modules.py::TestReg: 0.02 for the shift, else 0.03
            model = m[4:]
            i = reg.MODELS.index(model)
            warped = reg.warp_with_params(model, torch.from_numpy(o), torch.from_numpy(scene.reg_mov[i])).numpy()
            b = int(0.1 * min(H, W))
            g[m] = {"err": float(np.abs(warped[b:-b, b:-b] - scene.reg_ref[b:-b, b:-b]).mean()), "p": o.tolist()}
            ok = g[m]["err"] < (0.02 if model == "shift" else 0.03)
        elif m == "detect_markers":  # tests/test_breadth6.py::TestCharuco: >= 6 of the board's markers
            g[m] = {"ids": sorted(o[0])}
            ok = len(set(o[0]) & set(scene.board_ids)) >= 6
        elif m == "interpolate_charuco_corners":  # the 16 interior corners within 3 px of the lattice
            rel = o[1] - np.array(scene.board_origin, np.float32)
            err = float(np.abs(rel - np.round(rel / scene.square_px) * scene.square_px).max()) if len(o[0]) else 1e9
            g[m] = {"corners": len(o[0]), "lattice_px": err}
            ok = len(o[0]) == 16 and err < 3.0
        elif m == "estimate_pose_single_markers":  # test_pose_estimation: rotation 0.05 rad, translation 0.02 m
            ids, poses = o
            z = entry.GEO_FOCAL * entry.GEO_MARKER_M / scene.marker_span_px
            rot = max(float(se3.rotation_angle(torch.from_numpy(np.asarray(R)))) for R, _ in poses)
            tz = max(abs(float(t[2]) - z) for _, t in poses)
            g[m] = {"markers": len(poses), "rot_rad": rot, "tz_err_m": tz}
            ok = len(poses) >= 6 and rot < 0.05 and tz < 0.02
        elif m == "find_correspondences":  # tests/test_breadth8.py::TestRandomPattern::test_shifted_view
            obj, ip, n = o
            dx = ip[:, 0] - obj[:, 0] / (0.20 / W)
            dy = ip[:, 1] - obj[:, 1] / (0.16 / H)
            g[m] = {"n": n, "dx": float(np.median(dx)), "dy": float(np.median(dy))}
            ok = n >= 15 and abs(g[m]["dx"] - 7) < 1.0 and abs(g[m]["dy"] - 4) < 1.0
        elif m.startswith("calibrate_omni"):  # TestOmniCalibrate
            K, xi, _, _, rms = o
            f = float(scene.omni_K[0, 0])
            g[m] = {"rms_px": rms, "f": float(K[0, 0]), "xi": xi}
            ok = rms < 0.3 and abs(K[0, 0] - f) / f < 0.05 and abs(xi - scene.omni_xi) < (
                1e-6 if m.endswith("fix_xi") else 0.1)
        elif m == "undistort_image_omni":  # tests/test_breadth3.py::test_undistort_image_runs
            ok = o.shape == (H, W) and bool(np.isfinite(o).all())
            g[m] = {"finite": ok}
        elif m == "rapid_track":  # tests/test_detect_breadth.py::TestRapid
            e0 = float(np.linalg.norm(scene.rapid_t0 - scene.rapid_t))
            g[m] = {"err0_m": e0, "err_m": float(np.linalg.norm(o[1] - scene.rapid_t)), "used": float(o[2])}
            ok = g[m]["err_m"] < 0.6 * e0 and g[m]["used"] > 0.5
        elif m in ("ppf", "cloud_icp"):  # tests/test_surface_matching.py: TestPPF; TestCloudICP
            T_gt = scene.cloud_T_ppf if m == "ppf" else scene.cloud_T_icp
            T_est = o[2] if m == "ppf" else o[0]
            d = se3.log_se3(se3.inverse(torch.from_numpy(T_gt)) @ torch.from_numpy(np.asarray(T_est))).numpy()
            if m == "ppf":
                g[m] = {"votes": float(o[1]), "rot": float(np.linalg.norm(d[:3])),
                        "trans": float(np.linalg.norm(d[3:]))}
                ok = g[m]["votes"] > 10 and g[m]["rot"] < 0.05 and g[m]["trans"] < 0.05
            else:
                g[m] = {"twist": float(np.linalg.norm(d)), "err": float(o[1])}
                ok = g[m]["twist"] < 0.02 and g[m]["err"] < 1e-4
        else:
            raise KeyError(m)
        if not ok:
            missed[m] = g[m]
    check(not missed, f"geometry gates missed: {missed}")
    return g


# phase w: entry.track_x's methods (entry.TRACKING, checked) on entry.tracking_scene() at VGA, entry.stabilize_clip
# on entry.shaky_clip() and entry.superres_clip(). MedianFlow's LK builds 4 pyramids of 3 levels a step (8 pyrdown),
# TLD's MedianFlow 4 of 2 levels (4); MIL's and Boosting's Haar features take one batched integral launch a set of
# patches (the candidates, then both bags: 2 a step, 1 at init); the MultiTracker's MedianFlow 8 a step; the stabilizer's reg 4 pyrdown a frame
# pair; BTV's DIS flows 4 pyrdown and 9 remap a pair at 3 levels (3 pairs); nothing else of ours
TRACK_SHAPE = (480, 640)  # entry.tracking_scene()'s frame
TRACK_FRAMES = 30
TRACK_STEPS = TRACK_FRAMES - 1
TRACK_METHODS = ("mosse", "kcf", "csrt", "dsst", "csrt_scale", "kcf_scale", "kalman", "ukf", "aukf", "medianflow",
                 "tld", "mil", "boosting", "multi", "by_matching", "twist", "siam")
TRACK_LAUNCHES = {"medianflow": {"pyrdown": 8 * TRACK_STEPS}, "tld": {"pyrdown": 4 * TRACK_STEPS},
                  "mil": {"integral_image": 1 + 2 * TRACK_STEPS}, "boosting": {"integral_image": 1 + 2 * TRACK_STEPS},
                  "multi": {"pyrdown": 8 * TRACK_STEPS}}
STAB_FRAMES = 16  # entry.shaky_clip()'s
STAB_LAUNCHES = {"pyrdown": 4 * (STAB_FRAMES - 1)}
SUPERRES_LAUNCHES = {"pyrdown": 3 * 4, "remap": 3 * 9}
W_PATHS = tuple(f"track_{m}" for m in TRACK_METHODS) + ("stabilize_clip", "superres_clip")
# phase w's profiler window runs the paths on the clips' first frames: CUPTI over a whole run's ~800,000 launches
# cost 50-66 s (PERF.md section 6). The tracking paths that step the clip's frames run on its first 3 (2 steps),
# the stabilizer on its first 5 (4 motions, the least its deblur and wobble parts take); the rest run whole
W_PROFILE_FRAMES = {"track": 3, "stabilize_clip": 5}
W_CUT_PATHS = {f"track_{m}" for m in ("mosse", "kcf", "csrt", "medianflow", "tld", "mil", "boosting", "multi",
                                      "by_matching", "siam")}
PATH_KERNELS.update({f"track_{m}": tuple(TRACK_LAUNCHES.get(m, {})) for m in TRACK_METHODS})
PATH_KERNELS.update({"stabilize_clip": tuple(STAB_LAUNCHES), "superres_clip": tuple(SUPERRES_LAUNCHES)})
INTEGRAL_BATCHES = ((289, 32, 32), (441, 32, 32), (48, 32, 32))  # MIL's and Boosting's candidates, both bags
INTEGRAL_REPS = 30  # calls a timed function makes in the batched integral's profiler window
TRACK_CPU_THREADS = 4
BOOST_SEEDS = (1, 2, 3, 4)  # Boosting card against CPU again on these seeds' draws (bank and offsets), "track_boosting@<seed>"
# the card against the port's CPU run (`track_diff`): centres and boxes in px, the rest by their largest difference
# over the largest magnitude of the CPU's value. Read on the H100 (PERF.md section 6): the scaled CSRT's
# sub-pixel parabola over 19 zoom frames 0.387 px; MedianFlow's LK sums 0.0119 px; the Siamese backbone trained on
# each device (equal centres, scores 1.1%). Boosting's score is a vote of +-alpha stumps (summed in float64, exact on
# both devices), so many candidates tie exactly and the lower index wins; a stump whose log-likelihood ratio sits
# within an ulp of 0 (the features' integral order, the reductions' and `log`'s rounding differ by device) flips a
# vote and hands the tie to another candidate, one 1 px grid step away. Over the draws of seeds 0-4 (BOOST_SEEDS):
# centres 1, 2, 0, 0 and 2 px apart, scores up to 6.2% (read on the H100, PERF.md section 6)
TRACK_CPU_TOL = {"default": {"px": 1e-2, "rel": 1e-3}, "track_csrt_scale": {"px": 0.5},
                 "track_medianflow": {"px": 0.05}, "track_multi": {"px": 0.05},
                 "track_boosting": {"px": 3.0, "rel": 0.1}, "track_siam": {"rel": 0.02}}


def _draws_on_cpu(seed: int = 0):
    """The random draws of phase w's paths (MIL's and Boosting's offsets
    and bank, TLD's fern bank, the stabilizer's RANSAC hypotheses) from CPU
    generators of `seed`, moved to the generator's device: a card run and a
    CPU run take the same draws."""
    import torch

    from opencv_contrib_tpu_torch.tracking import mil, tld
    from opencv_contrib_tpu_torch.videostab import extra

    cpu = {k: torch.Generator().manual_seed(seed) for k in ("offsets", "bank", "ferns", "hypotheses")}
    draw_off, draw_bank, draw_ferns, draw_hyps = mil._sample_offsets, mil.make_feature_bank, tld.fern_bank, \
        extra._hypotheses

    def offsets(gen, n, radius, min_radius=0.0):
        return draw_off(cpu["offsets"], n, radius, min_radius).to(gen.device)

    def bank(gen, patch=32, n_features=250):
        return {k: v.to(gen.device) for k, v in draw_bank(cpu["bank"], patch, n_features).items()}

    def ferns(gen):
        return draw_ferns(cpu["ferns"]).to(gen.device)

    def hypotheses(gen, n_hyps, msize, N, device):
        return draw_hyps(cpu["hypotheses"], n_hyps, msize, N, "cpu").to(device)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(extra, "_hypotheses", hypotheses))
    stack.enter_context(mock.patch.object(mil, "_sample_offsets", offsets))
    stack.enter_context(mock.patch.object(mil, "make_feature_bank", bank))
    stack.enter_context(mock.patch.object(tld, "fern_bank", ferns))
    return stack


def track_cpu_outputs(shape, n_frames: int, threads: int) -> dict:
    """Every entry.track_x method on entry.tracking_scene(*shape, n_frames),
    entry.stabilize_clip on entry.shaky_clip(*shape) and
    entry.superres_clip() on the CPU, as numpy (phase w's CPU run, in a
    process of its own), the draws from `_draws_on_cpu`; Boosting again on
    the draws of each of BOOST_SEEDS; the run's seconds under "cpu_run_s"."""
    import torch

    from opencv_contrib_tpu_torch import entry

    t0 = time.perf_counter()
    torch.set_num_threads(threads)
    scene = entry.tracking_scene(*shape, n_frames)
    out = {}
    with _draws_on_cpu():
        for m in TRACK_METHODS:
            out[f"track_{m}"] = _geo_host(entry.track_x(scene, m, device="cpu"))
        out["stabilize_clip"] = _geo_host(entry.stabilize_clip(entry.shaky_clip(*shape, STAB_FRAMES), device="cpu"))
    for seed in BOOST_SEEDS:
        with _draws_on_cpu(seed):
            out[f"track_boosting@{seed}"] = _geo_host(entry.track_x(scene, "boosting", device="cpu"))
    out["cpu_run_s"] = time.perf_counter() - t0
    out["superres_clip"] = _geo_host(entry.superres_clip(device="cpu"))
    return out


def track_diff(card, host, path: str = "") -> dict:
    """How a card result (numpy, `_geo_host`) of `path` parts from the
    CPU's: every array by its largest difference, in px for centres and
    boxes and relative to the CPU value's largest magnitude for the rest
    (TRACK_CPU_TOL); host lists (the matched tracks) must be equal. Returns
    the readings and whether all hold."""
    tol = {**TRACK_CPU_TOL["default"], **TRACK_CPU_TOL.get(path, {})}
    r = {}

    def walk(a, b, key):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{key}.{k}" if key else k)
        elif isinstance(a, np.ndarray) and a.dtype.kind in "fc":
            if a.shape != b.shape:
                r[key] = (float("inf"), 0.0)
            elif key.split(".")[-1] in ("centers", "boxes"):
                r[key] = (float(np.abs(a - b).max()) if a.size else 0.0, tol["px"])
            else:
                top = float(np.abs(b).max()) if b.size else 0.0
                r[key] = (float(np.abs(a - b).max() / max(top, 1e-30)) if a.size else 0.0, tol["rel"])
        elif isinstance(a, np.ndarray):
            r[key] = (float(not np.array_equal(a, b)), 0.0)
        elif isinstance(a, list) and a and all(isinstance(v, np.ndarray) and v.dtype.kind == "f" for v in a):
            walk(np.stack(a), np.stack(b), key)  # the stabilized frames
        elif isinstance(a, (list, tuple)) and a and isinstance(a[0], (list, tuple, np.ndarray)):
            r[key] = (float(not _geo_equal(a, b)), 0.0)
        elif isinstance(a, (list, tuple)) and a and isinstance(a[0], float):
            top = max(abs(v) for v in b)
            r[key] = (max(abs(u - v) for u, v in zip(a, b)) / max(top, 1e-30), tol["rel"])

    walk(card, host, "")
    return {"ok": all(val <= bound for val, bound in r.values()), "diff": {k: v[0] for k, v in r.items()}}


def _iou_square(a: float, b: float) -> float:
    inter = min(a, b) ** 2
    return inter / (a * a + b * b - inter)


def tracking_gates(scene, outs: dict) -> dict:
    """The JAX tests' gates on each track_x result in `outs` (method ->
    result on `scene`, tensors or numpy); raises, naming every miss, after
    checking all. Returns the gated numbers."""
    from opencv_contrib_tpu_torch import entry

    g, missed = {}, {}
    truth = scene.centers[:, 0]
    H, W = scene.zoom.shape[1:]
    for m, out in outs.items():
        o = _geo_host(out)
        if m in ("mosse", "kcf", "csrt", "medianflow", "tld", "mil", "boosting"):
            err = np.linalg.norm(o["centers"] - truth, axis=1)[1:]
        if m == "mosse":  # TestMosse: < 2.5 px over its fixture's 11 updates, PSR > 5 there; the PSR drops on vanishing
            n = entry.MOSSE_UPDATES
            g[m] = {"err_px": float(err[:n].max()), "psr": float(o["psr"][n - 1]), "err_px_all": float(err.max()),
                    "psr_vanish": float(o["psr_vanish"]), "psr_last": float(o["psr"][-1])}
            ok = g[m]["err_px"] < 2.5 and g[m]["psr"] > 5.0 and g[m]["psr_vanish"] < g[m]["psr_last"]
        elif m == "kcf":  # TestKcf: < 2.5 px a frame
            g[m] = {"err_px": float(err.max())}
            ok = g[m]["err_px"] < 2.5
        elif m == "csrt":  # TestCsrt: < 3 px a frame
            g[m] = {"err_px": float(err.max())}
            ok = g[m]["err_px"] < 3.0
        elif m == "dsst":  # test_scale_stable_on_constant_size
            g[m] = {"scale": float(o["scale"][-1])}
            ok = 0.85 < g[m]["scale"] < 1.18
        elif m in ("csrt_scale", "kcf_scale"):  # TestDsstScale: IoU > 0.7 (csrt, + 0.2 over the stale box) / 0.6
            sizes = scene.zoom_sizes if m == "csrt_scale" else scene.zoom_kcf_sizes
            iou = _iou_square(float(o["boxes"][-1][0]), float(sizes[-1]))
            g[m] = {"iou": iou, "stale_iou": _iou_square(float(sizes[0]), float(sizes[-1])),
                    "centre_off_px": float(np.abs(o["centers"][-1] - [H / 2.0, W / 2.0]).max())}
            ok = iou > 0.7 and iou > g[m]["stale_iou"] + 0.2 and g[m]["centre_off_px"] < 4 if m == "csrt_scale" \
                else iou > 0.6
        elif m == "kalman":  # test_linear_constant_velocity: the velocity within 0.1
            g[m] = {"v": o["x"][2:].tolist()}
            ok = bool(np.abs(o["x"][2:] - [1.0, 0.5]).max() < 0.1)
        elif m == "ukf":  # test_ukf_nonlinear_range_bearing: the position within 0.15
            g[m] = {"pos_err": float(np.abs(o["x"][:2] - scene.ukf_truth[-1][:2]).max())}
            ok = g[m]["pos_err"] < 0.15
        elif m == "aukf":  # test_matches_kf_on_linear_additive: the AUKF is the KF within 1e-2
            kf = _geo_host(outs["kalman"]) if "kalman" in outs else None
            g[m] = {"x_vs_kf": float(np.abs(o["x"] - kf["x"]).max()) if kf else None,
                    "P_vs_kf": float(np.abs(o["P"] - kf["P"]).max()) if kf else None}
            ok = kf is not None and g[m]["x_vs_kf"] < 1e-2 and g[m]["P_vs_kf"] < 1e-2
        elif m == "medianflow":  # TestMedianFlow: ok and < 2.5 px a frame
            g[m] = {"err_px": float(err.max()), "all_ok": bool(o["ok"].all())}
            ok = g[m]["err_px"] < 2.5 and g[m]["all_ok"]
        elif m == "tld":  # TestTld: < 4 px a frame, the last confidence > 0.5
            g[m] = {"err_px": float(err.max()), "conf": float(o["conf"][-1])}
            ok = g[m]["err_px"] < 4.0 and g[m]["conf"] > 0.5
        elif m == "mil":  # TestMil: the last error < 6 px
            g[m] = {"err_px": float(err[-1])}
            ok = g[m]["err_px"] < 6.0
        elif m == "boosting":  # TestBoosting: the last error <= 2 px in each coordinate
            g[m] = {"err_px": float(np.abs(o["centers"][-1] - truth[-1]).max())}
            ok = g[m]["err_px"] <= 2.0
        elif m == "multi":  # test_mixed_kinds_follow_target: each < 3 px after its 4 updates
            e4 = np.abs(o["centers"][4] - scene.centers[4]).max(axis=1)
            g[m] = {"err_px_at_4": e4.tolist(), "err_px_last": np.abs(o["centers"][-1] - scene.centers[-1]).max(
                axis=1).tolist()}
            ok = bool((e4 < 3.0).all())
        elif m == "by_matching":  # TestTrackerByMatching: continuity, a spawn and a death
            ids = [sorted(i for i, _ in f) for f in o["tracks"]]
            a, b = entry.SPAWN_FRAMES
            want = [[0, 1, 2, 3] if a <= i < b + 5 else [0, 1, 2] for i in range(len(ids))]
            g[m] = {"ids_as_expected": ids == want}
            ok = ids == want
        elif m == "twist":  # TestTwist: 1e-5
            g[m] = {"err": float(np.abs(o["xi"] - scene.twist_xi).max())}
            ok = g[m]["err"] < 1e-5
        elif m == "siam":  # TestSiam::test_tracks_moving_object: within 4 px in each coordinate
            g[m] = {"err_px": float(np.abs(o["centers"][-1] - scene.siam_centers[-1]).max())}
            ok = g[m]["err_px"] <= 4.0
        else:
            raise KeyError(m)
        if not ok:
            missed[m] = g[m]
    check(not missed, f"tracking gates missed: {missed}")
    return g


def stab_gates(clip, res) -> dict:
    """tests/test_breadth2.py::TestVideostab and test_videostab2.py's gates
    on a stabilize_clip result; raises on a miss. Returns the numbers."""
    o = _geo_host(res)
    H, W = clip.frames.shape[1:]
    m = max(8, H // 15)

    def tvar(fs):
        return float(np.stack([f[m:-m, m:-m] for f in fs]).var(axis=0).mean())

    g = {"temporal_var": tvar(o["frames"]), "input_var": tvar(list(clip.frames))}
    Mr, Mt = o["ransac"], clip.motions[0]
    g["ransac_R"] = float(np.abs(Mr[:2, :2] - Mt[:2, :2]).max())
    g["ransac_t"] = float(np.abs(Mr[:2, 2] - Mt[:2, 2]).max())
    g["ransac_inliers"] = int(o["ransac_inliers"].sum())
    C, S = clip.trajectory, o["lp"]
    g["lp_d1_ratio"] = float(np.abs(np.diff(S, axis=0)).sum() / np.abs(np.diff(C, axis=0)).sum())
    g["lp_dev"] = float(np.abs(S - C).max())
    sharp = clip.frames[2][m:-m, m:-m]
    g["deblur_err"] = float(np.abs(o["deblurred"][m:-m, m:-m] - sharp).mean())
    g["blur_err"] = float(np.abs(o["blurred"][m:-m, m:-m] - sharp).mean())
    g["color_err"] = float(np.abs(o["color_filled"] - 0.7).max())
    g["mosaic_err"] = float(np.abs(o["mosaic_filled"][clip.hole] - clip.frames[0][clip.hole]).max())
    g["wobble_err"] = float(np.abs(o["wobble"] - clip.frames[3]).max())
    missed = {k: g[k] for k, bad in (
        ("temporal_var", g["temporal_var"] >= 0.6 * g["input_var"]), ("ransac_R", g["ransac_R"] > 0.02),
        ("ransac_t", g["ransac_t"] > 0.5), ("ransac_inliers", g["ransac_inliers"] < 45),
        ("lp_d1_ratio", g["lp_d1_ratio"] >= 0.6), ("lp_dev", g["lp_dev"] >= 0.15),
        ("deblur_err", g["deblur_err"] >= g["blur_err"]), ("color_err", g["color_err"] > 1e-3),
        ("mosaic_err", g["mosaic_err"] > 1e-4), ("wobble_err", g["wobble_err"] > 1e-4)) if bad}
    check(not missed, f"videostab gates missed: {missed}")
    return g


def superres_gates(res) -> dict:
    """tests/test_breadth2.py::TestSuperres's gates: the known-flow fusion's
    interior error < 0.35 of the upsampled frame's, the DIS-flow one's <
    2.5 of it; raises on a miss."""
    o = _geo_host(res)
    hr = o["hr"]

    def err(x):
        return float(np.abs(x[4:-4, 4:-4] - hr[4:-4, 4:-4]).mean())

    g = {"known": err(o["known"]), "dis": err(o["dis"]), "bicubic": err(o["bicubic"])}
    g["known_ratio"], g["dis_ratio"] = g["known"] / g["bicubic"], g["dis"] / g["bicubic"]
    check(g["known_ratio"] < 0.35 and g["dis_ratio"] < 2.5, f"superres gates missed: {g}")
    return g


# ---- phase x: background subtraction and the retina; detection, shape and face -----------------------------------
X_SHAPE = (480, 640)  # entry.background_clip()'s and entry.detection_scene()'s frames
BG_METHODS = ("mog", "cnt", "gmg", "gsoc", "lsbp", "retina_transient", "retina_color")
DET_METHODS = ("hog", "waldboost", "dpm", "eigenfaces", "fisherfaces", "lbph", "bif", "aam", "facemark",
               "shape_context", "tps", "emd", "affine")
X_PATHS = tuple(f"bg_{m}" for m in BG_METHODS) + tuple(f"det_{m}" for m in DET_METHODS)
# the integral kernel's launches a call: WaldBoost's 8 channel tables in one launch; the transient segmentation's
# sigma-6 blur three box passes a step; no other kernel of ours on any path of the phase
X_LAUNCHES = {"det_waldboost": {"integral_image": 1}, "bg_retina_transient": {"integral_image": 3 * 10}}
PATH_KERNELS.update({p: tuple(X_LAUNCHES.get(p, {})) for p in X_PATHS})
X_CPU_THREADS = 4
# the card against the port's CPU run (`x_diff`): masks, labels, integer arrays and host lists equal; floats by their
# largest difference over the larger of the CPU value's largest magnitude and `floor`; a subspace by its projector.
# Read on the H100 (PERF.md section 6): MOG, CNT, GMG, GSOC, LSBP, LBPH, WaldBoost and Facemark
# equal; the retina's neighbourhood context 7.1e-5 (the integral kernel's order of adds on the card, the XLA order on
# the CPU); the recognizers' distances 4.5e-5 and 4.9e-5; shape context: the two contours' descriptors part where
# `atan2` puts a point pair on a bin edge (a symmetric contour has many), so the chi2 costs part by 6.9e-5 (floor 1:
# they lie in [0, 1]) and the EMD cost matrices built on them by 8.0e-4 and 2.0e-3; TPS on the 300-point contour, a
# float32 LU of a 303 x 303 system, 4.7e-3
X_CPU_TOL = {"default": {"rel": 1e-4, "mask_off": 0.0, "floor": 1e-30, "subspace": 0.0},
             "bg_retina_transient": {"rel": 3e-4}, "det_eigenfaces": {"rel": 2e-4, "subspace": 3e-2},
             "det_fisherfaces": {"rel": 2e-4, "subspace": 1e-2}, "det_shape_context": {"rel": 3e-4, "floor": 1.0},
             "det_emd": {"rel": 6e-3}, "det_tps": {"rel": 1.5e-2}}
INTEGRAL_CHANNELS = (8, 480, 640)  # WaldBoost's ICF stack at VGA
X_EXACT_LEVELS = 50  # integer channels 0..50: an (8, 480, 640) table stays below 2**24


def _x_draws_on_cpu():
    """GSOC's and LSBP's replacement draws from a CPU generator of seed 0,
    moved to the frame's device: a card run and a CPU run take the same
    draws (each subtractor's run from a fresh generator, as the entry's)."""
    import torch

    from opencv_contrib_tpu_torch.bgsegm import gsoc

    gens = {}  # id -> (the subtractor's generator, kept alive so its id is not reused; its CPU stand-in)

    def uniform(gen, shape, device):
        cpu = gens.setdefault(id(gen), (gen, torch.Generator().manual_seed(0)))[1]
        return torch.rand(shape, generator=cpu).to(device)

    return mock.patch.object(gsoc, "_uniform", uniform)


def x_cpu_outputs(shape, threads: int) -> dict:
    """Every entry.background_x and entry.detect_x method on the CPU at
    `shape`, as numpy (phase x's CPU run, in a process of its own), GSOC and
    LSBP on `_x_draws_on_cpu`; the run's seconds under "cpu_run_s" and its
    detection scene under "scene"."""
    import torch

    from opencv_contrib_tpu_torch import entry

    t0 = time.perf_counter()
    torch.set_num_threads(threads)
    clip, scene = entry.background_clip(*shape), entry.detection_scene(*shape)
    out = {"scene": scene}  # the card runs on this scene too: its models are trained once, here
    with _x_draws_on_cpu():
        for m in BG_METHODS:
            out[f"bg_{m}"] = _geo_host(entry.background_x(clip, m, device="cpu"))
    for m in DET_METHODS:
        out[f"det_{m}"] = _geo_host(entry.detect_x(scene, m, device="cpu"))
    out["cpu_run_s"] = time.perf_counter() - t0
    return out


def x_diff(card, host, path: str = "") -> dict:
    """How a card result (numpy, `_geo_host`) of a phase-x path parts from
    the CPU's: float arrays and numbers by their largest difference over the
    CPU value's largest magnitude, masks by their share of differing
    elements, integer arrays and host lists (labels, detections) by
    equality (X_CPU_TOL)."""
    tol = {**X_CPU_TOL["default"], **X_CPU_TOL.get(path, {})}
    r = {}

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            return float("inf")
        top = float(np.abs(b).max()) if b.size else 0.0
        return float(np.abs(a - b).max() / max(top, tol["floor"])) if a.size else 0.0

    def walk(a, b, key):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{key}.{k}" if key else k)
        elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
            r[key] = (rel(a, b), tol["rel"])
        elif isinstance(a, np.ndarray) and a.dtype == bool:
            r[key] = (float(np.mean(a != b)) if a.shape == b.shape else 1.0, tol["mask_off"])
        elif isinstance(a, np.ndarray):
            r[key] = (float(not np.array_equal(a, b)), 0.0)
        elif isinstance(a, list):  # predictions (label, distance) and DPM's detections (y, x, scale, score)
            same = len(a) == len(b) and all(u[:-1] == v[:-1] for u, v in zip(a, b))
            r[key + "#"] = (float(not same), 0.0)
            if same and a:
                r[key] = (rel([u[-1] for u in a], [v[-1] for v in b]), tol["rel"])
        elif isinstance(a, float):
            r[key] = (rel(a, b), tol["rel"])

    if path in ("det_eigenfaces", "det_fisherfaces"):
        # SVD and eigh bases are free up to each column's sign, and near-equal singular values turn them within
        # their span: the subspaces are held by their orthonormal bases' projectors, ||P1 - P2||_F / ||P2||_F with
        # ||P1 - P2||_F^2 = 2K - 2 ||B1^T B2||_F^2
        B1, B2 = (np.asarray(m["model"]["basis"], np.float64) for m in (card, host))
        K = B2.shape[1]
        r["model.subspace"] = (float(np.sqrt(max(2 * K - 2 * np.sum((B1.T @ B2) ** 2), 0.0) / K)), tol["subspace"])
        card = {**card, "model": {k: v for k, v in card["model"].items() if k not in ("basis", "projections")}}
    walk(card, host, "")
    return {"ok": all(val <= bound for val, bound in r.values()), "diff": {k: v[0] for k, v in r.items()}}


def _region(a, box):
    y0, y1, x0, x1 = box
    return a[y0:y1, x0:x1]


def background_gates(clip, outs: dict) -> dict:
    """The JAX tests' gates on each background_x result in `outs` (method ->
    result on `clip`, tensors or numpy), in the tests' regions scaled to the
    clip (`entry.bg_regions`); raises, naming every miss, after checking
    all. Returns the gated numbers."""
    from opencv_contrib_tpu_torch import entry

    H, W = clip.gmg.shape[1:]
    reg = entry.bg_regions(H, W)
    g, missed = {}, {}
    for m, out in outs.items():
        o = _geo_host(out)
        if m == "mog":  # TestMog: hits > 0.7, false positives < 0.1 over frames 15..; a static scene < 0.05
            gt, patch = clip.mog_masks[15:], clip.mog_patch_masks[15:]
            g[m] = {"hits": float(np.mean([f[p].mean() for f, p in zip(o["fg"], patch)])),
                    "false_pos": float(np.mean([f[~t].mean() for f, t in zip(o["fg"], gt)])),
                    "hits_scaled_object": float(np.mean([f[t & ~p].mean() for f, t, p in zip(o["fg"], gt, patch)])),
                    "static_fg": float(o["fg_static"].mean())}
            ok = g[m]["hits"] > 0.7 and g[m]["false_pos"] < 0.1 and g[m]["static_fg"] < 0.05
        elif m == "cnt":  # TestCnt: > 0.6 of the object, < 0.15 elsewhere, on frame 25
            t = clip.cnt_masks[25]
            g[m] = {"hits": float(o["fg"][t].mean()), "false_pos": float(o["fg"][~t].mean())}
            ok = g[m]["hits"] > 0.6 and g[m]["false_pos"] < 0.15
        elif m == "gmg":  # TestGmg: nothing during init; > 0.9 inside the object, < 0.05 far from it
            g[m] = {"init_any_fg": bool(o["init_any_fg"]), "inside": float(_region(o["fg"], reg["gmg_inside"]).mean()),
                    "outside": float(_region(o["fg"], reg["gmg_outside"]).mean())}
            ok = not g[m]["init_any_fg"] and g[m]["inside"] > 0.9 and g[m]["outside"] < 0.05
        elif m in ("gsoc", "lsbp"):  # TestGsocLsbp: tp > 0.6 and fp < 0.15 (GSOC); tp > 0.5 and a flat image's code 0
            t = getattr(clip, m + "_masks")[-1]
            g[m] = {"tp": float((o["fg"] & t).sum() / max(t.sum(), 1)),
                    "fp": float((o["fg"] & ~t).sum() / max((~t).sum(), 1))}
            if m == "gsoc":
                ok = g[m]["tp"] > 0.6 and g[m]["fp"] < 0.15
            else:
                g[m]["flat_code_max"] = int(o["flat_code"].max())
                ok = g[m]["tp"] > 0.5 and g[m]["flat_code_max"] == 0
        elif m == "retina_transient":  # TestRetina: contrast ratio in (0.2, 5), magno x2 on motion; TestTransient
            c_dark = float(_region(o["parvo"], reg["retina_dark"]).std())
            c_bright = float(_region(o["parvo"], reg["retina_bright"]).std())
            g[m] = {"contrast_ratio": c_dark / max(c_bright, 1e-9),
                    "magno_ratio": float(o["magno_moving"].mean() / o["magno_static"].mean()),
                    "seg_inside": float(_region(o["seg"], reg["seg_inside"]).mean()),
                    "seg_corner": float(_region(o["seg"], reg["seg_corner"]).mean())}
            ok = (0.2 < g[m]["contrast_ratio"] < 5.0 and g[m]["magno_ratio"] > 2.0 and g[m]["seg_inside"] > 0.7
                  and g[m]["seg_corner"] < 0.1)
        elif m == "retina_color":  # tests/test_breadth9.py::TestRetinaColor
            p95o, p5o = np.percentile(o["tone_gray"], [95, 5])
            p95i, p5i = np.percentile(clip.hdr, [95, 5])
            g[m] = {"demux_err": float(np.abs(o["demux"] - clip.smooth).mean()),
                    "masks_partition": bool(np.allclose(o["masks_sum"], 1.0)),
                    "tone_spread": float((p95o - p5o) / (p95o + p5o + 1e-9)),
                    "input_spread": float((p95i - p5i) / (p95i + p5i + 1e-9)),
                    "tone_color_finite": bool(np.isfinite(o["tone_color"]).all())}
            ok = (g[m]["demux_err"] < 0.03 and g[m]["masks_partition"] and g[m]["tone_spread"] < g[m]["input_spread"]
                  and g[m]["tone_color_finite"] and o["parvo_rgb"].shape == (H, W, 3) and o["magno"].shape == (H, W))
        else:
            raise AssertionError(f"no gate for background method {m!r}")
        if not ok:
            missed[m] = g[m]
    check(not missed, f"background gates missed: {missed}")
    return g


def detection_gates(scene, outs: dict) -> dict:
    """The JAX tests' gates on each detect_x result in `outs` (method ->
    result on `scene`, tensors or numpy); raises, naming every miss, after
    checking all. Returns the gated numbers."""
    from opencv_contrib_tpu_torch import entry

    g, missed = {}, {}
    for m, out in outs.items():
        o = _geo_host(out)
        if m == "hog":  # TestHog::test_svm_detection: the best box within 8 px of the target
            best = o["boxes"][int(np.argmax(o["scores"]))] if len(o["scores"]) else np.full(4, np.inf)
            g[m] = {"detections": int(len(o["scores"])), "best_off_px": float(np.abs(best[:2] - scene.hog_at).max())}
            ok = g[m]["detections"] > 0 and g[m]["best_off_px"] <= 8
        elif m == "waldboost":  # test_detect_localizes: the top cluster's centroid within 4 px
            sc = o["scores"]
            top = o["centers"][sc >= sc.max() - 1e-3] if len(sc) else np.full((1, 2), np.inf)
            g[m] = {"detections": int(len(sc)), "centroid_off_px": float(np.abs(top.mean(0) - scene.wb_center).max())}
            ok = g[m]["detections"] > 0 and g[m]["centroid_off_px"] <= 4
        elif m == "dpm":  # TestDpm: the pattern found within 16 px; the deformed one fires above the noise's best
            first = o["dets"][0] if o["dets"] else (np.inf, np.inf, 0, -np.inf)
            best_noise = max((d[3] for d in o["noise"]), default=-np.inf)
            g[m] = {"off_px": float(max(abs(first[0] - (scene.dpm_at[0] + 32)), abs(first[1] - (scene.dpm_at[1] + 24)))),
                    "deformed_score": float(o["deformed"][0][3]) if o["deformed"] else None,
                    "noise_best": float(best_noise)}
            ok = g[m]["off_px"] <= 16 and o["deformed"] and o["deformed"][0][3] > best_noise
        elif m in ("eigenfaces", "fisherfaces"):  # TestEigenFaces: all; TestFisherFaces: all but one
            correct = sum(int(p == i) for i, (p, _) in enumerate(o["predictions"]))
            g[m] = {"correct": correct, "of": len(o["predictions"])}
            ok = correct >= len(o["predictions"]) - (0 if m == "eigenfaces" else 1)
        elif m == "lbph":  # TestLBPH: base 1, 2x base 3 (illumination), the updated identity
            g[m] = {"predictions": [p for p, _ in o["predictions"]]}
            ok = g[m]["predictions"] == [1, 3, entry.LBPH_NEW_LABEL]
        elif m == "bif":  # TestBIF: 4 x 6 x 4 features; orientation sensitivity; discriminative
            per_rot = o["stripes"].reshape(2, 4, 4).mean(axis=(0, 1))
            g[m] = {"orientation_ratio": float(per_rot.max() / max(per_rot.min(), 1e-12)),
                    "a_vs_b": float(np.abs(o["a"] - o["b"]).max())}
            ok = (o["a"].shape == (4 * 6 * 4,) and o["faces"].shape[1] == 8 * 12 * 4
                  and g[m]["orientation_ratio"] > 3 and g[m]["a_vs_b"] > 1e-3)
        elif m == "aam":  # TestFacemarkAAM: < 1.5 px and under half the box init's error
            e0 = float(np.linalg.norm(o["init"] - scene.aam_truth, axis=1).mean())
            e1 = float(np.linalg.norm(o["shape"] - scene.aam_truth, axis=1).mean())
            g[m] = {"init_px": e0, "fit_px": e1}
            ok = e1 < 1.5 and e1 < 0.5 * e0
        elif m == "facemark":  # TestFacemark: < 4 px and under the mean shape's error
            err = float(np.linalg.norm(o["shape"] - scene.fm_truth, axis=1).mean())
            err0 = float(np.linalg.norm(o["mean_px"] - scene.fm_truth, axis=1).mean())
            g[m] = {"fit_px": err, "mean_shape_px": err0}
            ok = err < err0 and err < 4.0
        elif m == "shape_context":  # TestShape: same shape nearer than another; Hausdorff 0 and ~0.5 offset
            g[m] = {k: float(o[k]) for k in ("same", "diff", "haus_zero", "haus_offset")}
            ok = g[m]["same"] < g[m]["diff"] and g[m]["haus_zero"] < 1e-6 and 0.3 < g[m]["haus_offset"] < 0.9
        elif m == "tps":  # TestShape: interpolates within 1e-2, the affine part within 1e-3; the contour warp
            g[m] = {"interp": float(np.abs(o["interp"] - scene.tps_dst).max()),
                    "affine": float(np.abs(o["affine"] - o["affine_truth"]).max()),
                    "contour": float(np.abs(o["contour"] - scene.wavy).max())}
            ok = g[m]["interp"] < 1e-2 and g[m]["affine"] < 1e-3 and g[m]["contour"] < 1e-2
        elif m == "emd":  # TestEMD: 3 (1e-5), 4 (5%), 2 (5%); cost matrices of the contours' descriptors
            g[m] = {k: float(o[k]) for k in ("shift", "grid", "sinkhorn")}
            g[m]["cost_grid_min"] = float(o["cost_grid"].min())
            ok = (abs(g[m]["shift"] - 3) < 1e-5 and abs(g[m]["grid"] - 4) < 0.2 and abs(g[m]["sinkhorn"] - 2) < 0.1
                  and o["cost_1d"].shape == (entry.EMD_DESCS,) * 2 and g[m]["cost_grid_min"] >= -1e-6)
        elif m == "affine":  # TestAffineTransformer
            g[m] = {"M": float(np.abs(o["M"] - np.array(entry.AFFINE_TRUE)).max()),
                    "applied": float(np.abs(o["applied"] - o["dst"]).max()),
                    "similarity": float(np.abs(o["M_sim"][:, :2] - o["R"]).max()),
                    "cost_rotation": float(o["cost_rotation"]), "cost_sheared": float(o["cost_sheared"])}
            ok = (g[m]["M"] < 1e-4 and g[m]["applied"] < 1e-3 and g[m]["similarity"] < 1e-4
                  and abs(g[m]["cost_rotation"]) < 1e-5 and g[m]["cost_sheared"] > 0.1)
        else:
            raise AssertionError(f"no gate for detection method {m!r}")
        if not ok:
            missed[m] = g[m]
    check(not missed, f"detection gates missed: {missed}")
    return g


# ---- phase y: hashes and saliency, lines and MIH, the colour chart, the ER filter and OCR, QR --------------------
Y_SHAPE = (480, 640)  # entry.recognition_scene()'s frames
Y_METHODS = ("average_hash", "block_mean_hash", "phash", "color_moment_hash", "radial_variance_hash",
             "marr_hildreth_hash", "spectral_residual", "fine_grained", "bing", "motion", "lines_lbd", "mih", "mcc",
             "er", "ocr_viterbi", "ocr_beam", "qr")
Y_PATHS = tuple(f"rec_{m}" for m in Y_METHODS)
# the integral kernel's launches a call: fine-grained saliency's table and BING's; no other kernel of ours on any path
Y_LAUNCHES = {"rec_fine_grained": {"integral_image": 1}, "rec_bing": {"integral_image": 1}}
PATH_KERNELS.update({p: tuple(Y_LAUNCHES.get(p, {})) for p in Y_PATHS})
Y_CPU_THREADS = 4
Y_FINE_INT_SEED = 7  # the integer frame (0..X_EXACT_LEVELS) fine-grained saliency runs on bit for bit
# the card against the port's CPU run (`y_diff`): masks, integer arrays, boxes, codes, MIH indices and strings equal;
# floats by their largest difference over the larger of the CPU value's largest magnitude and `floor`. A hash bit may
# differ where its compared value lies within `hash_bit` of the compared values' largest magnitude of its threshold
# (`hash_margins`: the mean, the median, or the centre block). Read on the H100 (PERF.md section 6): every hash bit,
# code, MIH index, box, mask and string equal; the spectral residual 2.3e-6 (cuFFT against the CPU's FFT); the radial
# variances 9.2e-5 (their sums' order); fine-grained saliency on U(0, 1) 1.44e-2: its 2 x 2 centre box is 4 table
# entries near 1.5e5 (an ulp 0.0156) apart over 4 pixels, so the integral kernel's order of adds, not the CPU's, moves a
# box mean by ~0.01 of the [0, 1] map; on the integer frame, whose table is exact, it is bit-equal
Y_CPU_TOL = {"default": {"rel": 1e-4, "floor": 1e-30, "hash_bit": 1e-5},
             "rec_fine_grained": {"rel": 3e-2}, "rec_radial_variance_hash": {"rel": 3e-4}}
BINARY_HASHES = ("average_hash", "block_mean_hash", "phash", "marr_hildreth_hash")


def hash_margins(method: str, img) -> np.ndarray:
    """Each bit of a binary hash of `img` (host, gray) as its compared
    value's distance from its threshold over the compared values' largest
    magnitude, computed by the port on the CPU (the hashes' own steps)."""
    import torch

    from opencv_contrib_tpu_torch.img_hash import hashes
    from opencv_contrib_tpu_torch.ops import filters
    from opencv_contrib_tpu_torch.ops.image import resize

    g = torch.as_tensor(np.asarray(img, np.float32))
    if method == "average_hash":
        v = resize(g, (8, 8), method="area") if g.shape[0] % 8 == 0 else resize(g, (8, 8))
        v, t = v.reshape(-1), v.mean()
    elif method == "block_mean_hash":
        v = resize(g, (64, 64)).reshape(16, 4, 16, 4).mean(dim=(1, 3)).reshape(-1)
        t = hashes._median(v)
    elif method == "phash":
        M = hashes._dct_matrix(32)
        v = (M @ resize(g, (32, 32)) @ M.T)[:8, :8].reshape(-1)
        t = hashes._median(v[1:])
    else:  # marr_hildreth_hash: each neighbour block against its centre, over the blocks' scale
        b = filters.laplacian(filters.gaussian_blur(resize(g, (64, 64)), 2.0)).reshape(16, 4, 16, 4).mean(dim=(1, 3))
        c = b[1:-1, 1:-1]
        d = torch.cat([(b[1 + dy:15 + dy, 1 + dx:15 + dx] - c).reshape(-1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                       if dy or dx])
        return (torch.abs(d) / torch.clamp(b.abs().max(), min=1e-30)).numpy()
    return (torch.abs(v - t) / torch.clamp(v.abs().max(), min=1e-30)).numpy()


def _hash_inputs(scene) -> dict:
    """The gray frames a binary hash path hashes, by its output key."""
    a = scene.hash_a[..., 0]
    return {"a": a, "noisy": a + scene.hash_noise, "other": scene.hash_other[..., 0]}


def y_cpu_outputs(shape, threads: int) -> dict:
    """Every entry.recognize_x method on the CPU at `shape`, as numpy (phase
    y's CPU run, in a process of its own), and fine-grained saliency of the
    integer frame; the run's seconds under "cpu_run_s", its scene under
    "scene", the integer frame under "fine_int_frame"."""
    import torch

    from opencv_contrib_tpu_torch import entry, saliency

    t0 = time.perf_counter()
    torch.set_num_threads(threads)
    scene = entry.recognition_scene(*shape)
    out = {"scene": scene}
    for m in Y_METHODS:
        out[f"rec_{m}"] = _geo_host(entry.recognize_x(scene, m, device="cpu"))
    ints = np.round(np.random.default_rng(Y_FINE_INT_SEED).uniform(0, X_EXACT_LEVELS, shape)).astype(np.float32)
    out["fine_int_frame"], out["fine_int_sal"] = ints, saliency.fine_grained(torch.from_numpy(ints)).numpy()
    out["cpu_run_s"] = time.perf_counter() - t0
    return out


def y_diff(card, host, path: str = "", scene=None) -> dict:
    """How a card result (numpy, `_geo_host`) of a phase-y path parts from
    the CPU's (Y_CPU_TOL): floats by their largest difference over the CPU
    value's largest magnitude; masks, integer arrays, host boxes and strings
    by equality, except a binary hash's bits within `hash_bit` of their
    threshold (with `scene`, from `hash_margins`; their count under
    "hash_bits_near_threshold")."""
    tol = {**Y_CPU_TOL["default"], **Y_CPU_TOL.get(path, {})}
    r, near = {}, 0
    method = path[len("rec_"):]
    margins = ({k: hash_margins(method, v) for k, v in _hash_inputs(scene).items()}
               if method in BINARY_HASHES and scene is not None else {})

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            return float("inf")
        top = float(np.abs(b).max()) if b.size else 0.0
        return float(np.abs(a - b).max() / max(top, tol["floor"])) if a.size else 0.0

    def walk(a, b, key):
        nonlocal near
        if isinstance(a, dict):
            if set(a) != set(b):
                r[key + "#keys"] = (1.0, 0.0)
            for k in a:
                if k in b:
                    walk(a[k], b[k], f"{key}.{k}" if key else k)
        elif isinstance(a, np.ndarray) and a.dtype == bool and key in margins:
            off = a != b if a.shape == b.shape else np.ones(margins[key].shape, bool)
            near += int(off.sum())
            r[key] = (float(margins[key][off].max()) if off.any() else 0.0, tol["hash_bit"])
        elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
            r[key] = (rel(a, b), tol["rel"])
        elif isinstance(a, np.ndarray):
            r[key] = (float(not (a.shape == b.shape and np.array_equal(a, b))), 0.0)
        elif isinstance(a, float):
            r[key] = (rel(a, b), tol["rel"])
        else:  # strings, None, ints
            r[key] = (float(a != b), 0.0)

    walk(card, host, "")
    return {"ok": all(val <= bound for val, bound in r.values()), "diff": {k: v[0] for k, v in r.items()},
            "hash_bits_near_threshold": near}


def recognition_gates(scene, outs: dict) -> dict:
    """The JAX tests' gates on each recognize_x result in `outs` (method ->
    result on `scene`, tensors or numpy), their objects and regions scaled
    to the scene (`entry.recognition_regions`); raises, naming every miss,
    after checking all. Returns the gated numbers."""
    from opencv_contrib_tpu_torch import entry
    from opencv_contrib_tpu_torch.mcc import MACBETH_SRGB

    H, W = scene.spectral_frame.shape
    reg = entry.recognition_regions(H, W)
    g, missed = {}, {}
    for m, out in outs.items():
        o = _geo_host(out)
        if m in BINARY_HASHES:  # TestImgHash: noisy closer than other, and at most 15% of the bits
            g[m] = {"noisy": int((o["a"] != o["noisy"]).sum()), "other": int((o["a"] != o["other"]).sum()),
                    "bits": int(o["a"].size)}
            ok = g[m]["noisy"] < g[m]["other"] and g[m]["noisy"] <= 0.15 * g[m]["bits"]
        elif m == "color_moment_hash":  # the 0.98 copy closer than another frame
            g[m] = {"scaled": float(np.linalg.norm(o["a"] - o["scaled"])),
                    "other": float(np.linalg.norm(o["a"] - o["other"]))}
            ok = g[m]["scaled"] < g[m]["other"]
        elif m == "radial_variance_hash":  # a 180-degree turn keeps the radial variances (atol 0.15)
            g[m] = {"rot180": float(np.abs(o["a"] - o["rot180"]).max())}
            ok = g[m]["rot180"] <= 0.15
        elif m == "spectral_residual":  # the block above 1.5 x the top and bottom bands
            s, k = o["sal"], reg["spectral_top"]
            y0, y1, x0, x1 = reg["spectral_block"]
            g[m] = {"inside": float(s[y0:y1, x0:x1].mean()),
                    "outside": float(np.concatenate([s[:k].ravel(), s[-k:].ravel()]).mean())}
            ok = g[m]["inside"] > 1.5 * g[m]["outside"]
        elif m == "fine_grained":  # test_fine_grained_runs: the frame's shape, values in [0, 1]
            g[m] = {"shape": list(o["sal"].shape), "min": float(o["sal"].min()), "max": float(o["sal"].max())}
            ok = tuple(g[m]["shape"]) == (H, W) and g[m]["min"] >= 0.0 and g[m]["max"] <= 1.0
        elif m == "bing":  # TestBing: the top box covers more than half a window of the object
            b = o["boxes"][0]
            y0, y1, x0, x1 = reg["bing_object"]
            inter = max(0, min(b[2], y1) - max(b[0], y0)) * max(0, min(b[3], x1) - max(b[1], x0))
            g[m] = {"top_box": [int(v) for v in b], "overlap": float(inter / reg["bing_size"] ** 2)}
            ok = g[m]["overlap"] > 0.5
        elif m == "motion":  # test_motion_saliency: the moved block above 0.8, the background below 0.1
            y0, y1, x0, x1 = reg["motion_block"]
            by0, _, bx0, _ = reg["motion_background"]
            g[m] = {"inside": float(o["sal"][y0:y1, x0:x1].mean()), "background": float(o["sal"][by0:, bx0:].mean())}
            ok = g[m]["inside"] > 0.8 and g[m]["background"] < 0.1
        elif m == "lines_lbd":  # test_end_to_end_with_lbd: the bar's edge found; LBD self-match is the identity
            v, segs = o["valid"], o["segments"]
            b0, b1 = reg["lines_bar"]
            step = 2 * np.hypot(H, W) / 256  # the Hough's rho bin
            bar = [s for s, ok_ in zip(segs, v) if ok_ and abs(s[0] - s[2]) <= 2
                   and min(abs(s[0] - b0), abs(s[0] - b1)) <= step and abs(s[1] - s[3]) >= W / 2]
            g[m] = {"valid": int(v.sum()), "bar_segments": len(bar),
                    "self_match": bool((o["idx"][v, 0] == np.arange(len(v))[v]).all())}
            ok = g[m]["bar_segments"] > 0 and g[m]["self_match"]
        elif m == "mih":  # every query finds its source at distance 2
            g[m] = {"found": int(((o["idx"][:, 0] == scene.mih_src) & (o["dist"][:, 0] == entry.MIH_FLIPS)).sum()),
                    "queries": int(len(scene.mih_src))}
            ok = g[m]["found"] == g[m]["queries"]
        elif m == "mcc":  # TestMccDetector: M within 0.08 of I; the colours as test_rotated_30_degrees (0.05)
            ok = o["M"] is not None
            g[m] = {"M_off_identity": float(np.abs(o["M"] - np.eye(3)).max()) if ok else None,
                    "colour_err": float(np.abs(o["measured"] - np.asarray(MACBETH_SRGB)).mean()) if ok else None}
            ok = ok and g[m]["M_off_identity"] <= 0.08 and g[m]["colour_err"] < 0.05
        elif m == "er":  # TestEr: a hit on a bar, >= 2 boxes; at least as many boxes on the bars as on noise
            hy0, hy1, hx0, hx1 = reg["er_hit"]
            hit = any(b[0] <= hy0 and b[2] >= hy1 and b[1] <= hx0 and b[3] >= hx1 for b in o["glyphs"])
            g[m] = {"boxes": int(len(o["glyphs"])), "hit": bool(hit), "glyph_boxes": int(len(o["glyphs_min_area"])),
                    "noise_boxes": int(len(o["noise_min_area"]))}
            ok = hit and g[m]["boxes"] >= 2 and g[m]["glyph_boxes"] >= g[m]["noise_boxes"]
        elif m in ("ocr_viterbi", "ocr_beam"):  # TestHMM: each line read as rendered
            g[m] = {k: o[k] for k in entry.OCR_TEXTS}
            ok = g[m] == entry.OCR_TEXTS
        elif m == "qr":  # both codes decoded
            g[m] = {k: o[k] for k in entry.QR_TEXTS}
            ok = g[m] == entry.QR_TEXTS
        else:
            raise AssertionError(f"no gate for recognition method {m!r}")
        if not ok:
            missed[m] = g[m]
    check(not missed, f"recognition gates missed: {missed}")
    return g


# ---- phase z: the learned models trained in the repo, signal, fuzzy, alphamat, plot ------------------------------
Z_SHAPE = (480, 640)  # entry.learned_scene()'s frames
Z_CPU_SHAPE = (120, 160)  # the card-against-CPU comparison's scene (EDSR and the (HW, 2,048) matte at VGA on 4 cores
# would take minutes)
Z_TRAIN = ("espcn", "fsrcnn", "lapsrn", "squeezedet", "crnn", "qr_detector", "qr_sr")
Z_METHODS = ("sr_espcn", "sr_fsrcnn", "sr_edsr", "sr_lapsrn", "sr_lapsrn4", "sr_evaluate", "squeezedet", "crnn",
             "qr_learned", "qr_sr", "info_flow", "info_flow_nonlocal", "f0_filter", "f1_filter", "f0_inpaint", "plot2d",
             "resample_signal")
Z_PATHS = tuple(f"learn_{m}" for m in Z_METHODS)
# the quality kernels of the SR evaluation: psnr is one grid_reduce (the MSE), ssim one grid_transform (the map) and
# one grid_reduce (its mean); sr_evaluate scores FSRCNN and the bicubic baseline on one frame, FSRCNN's recipe 8
# held-out scenes for each, LapSRN's 4 before and 4 after; no other kernel of ours on any path
Z_LAUNCHES = {"learn_sr_evaluate": {"grid_transform": 2, "grid_reduce": 4},
              "train_fsrcnn": {"grid_transform": 16, "grid_reduce": 32},
              "train_lapsrn": {"grid_transform": 8, "grid_reduce": 16}}
PATH_KERNELS.update({p: tuple(Z_LAUNCHES.get(p, {})) for p in Z_PATHS + tuple(f"train_{n}" for n in Z_TRAIN)})
Z_CPU_THREADS = 4
# the card against the port's CPU run at Z_CPU_SHAPE (`z_diff`): floats by their largest difference over the CPU
# value's largest magnitude (cuDNN's and the CPU's convolutions sum in other orders: 1e-6 of a net's output; the
# matte's 150 CG steps amplify the reductions' order); strings, texts, classes and decoded QR equal; the learned QR
# boxes within `box_px` (a corner truncates a float, as the twin's int()); SqueezeDet's kept boxes by the same rule
# as floats; plot2d's lit pixels equal but `plot_px` (a densified sample on a .5 rounds either way)
Z_CPU_TOL = {"rel": 1e-4, "matte_rel": 1e-3, "floor": 1e-30, "box_px": 1, "plot_px": 4}


def z_training_data() -> dict:
    """The QR recipes' host batches (entry.learned_batches), every step's,
    made in the spawned process ahead of phase z (4,800 detector scenes
    and 2,000 SR crops: 10-15 s of host numpy that the training no longer
    waits for)."""
    from opencv_contrib_tpu_torch import entry

    return {name: entry.learned_batches(name) for name in ("qr_detector", "qr_sr")}


def z_models(states: dict, device) -> dict:
    """The models of entry.learned_models rebuilt on `device` from their
    state dicts as numpy ({key: {param: array}}, `z_states`)."""
    import torch

    from opencv_contrib_tpu_torch.models import DnnSuperRes, dnn_objdetect
    from opencv_contrib_tpu_torch.text import crnn
    from opencv_contrib_tpu_torch.wechat_qrcode import learned

    def sd(key):
        return {k: torch.from_numpy(v) for k, v in states[key].items()}

    out = {k: DnnSuperRes(a, s, device=device, params=sd(k))
           for k, (a, s) in {"espcn": ("espcn", 2), "fsrcnn": ("fsrcnn", 2), "edsr": ("edsr", 2),
                             "lapsrn": ("lapsrn", 2), "lapsrn4": ("lapsrn", 4), "qr_sr": ("espcn", 2)}.items()}
    det = dnn_objdetect.SqueezeDetLite()
    det.load_state_dict(sd("squeezedet_vga"))
    out["squeezedet_vga"] = det.to(device)
    rec = crnn.CRNN()
    rec.load_state_dict(sd("crnn"))
    out["crnn"] = rec.to(device)
    net = learned.QrDetectorNet()
    net.load_state_dict(sd("qr_detector"))
    out["qr_detector"] = learned.QrDetector(net.to(device))
    return out


def z_states(models: dict) -> dict:
    """The learned_x models' weights as numpy state dicts (what crosses to
    the CPU run)."""
    def sd(m):
        mod = m.net if hasattr(m, "net") else (m.params if hasattr(m, "params") else m)
        return {k: v.detach().cpu().numpy() for k, v in mod.state_dict().items()}

    return {k: sd(v) for k, v in models.items()}


def z_cpu_outputs(states: dict, shape, threads: int) -> dict:
    """Every entry.learned_x method on the CPU at `shape` with the card's
    trained weights, as numpy (phase z's CPU run, in the spawned process
    behind phase y's); its seconds under "cpu_run_s"."""
    import torch

    from opencv_contrib_tpu_torch import entry

    t0 = time.perf_counter()
    torch.set_num_threads(threads)
    models, scene = z_models(states, "cpu"), entry.learned_scene(*shape)
    out = {f"learn_{m}": _geo_host(entry.learned_x(m, models, scene, device="cpu")) for m in Z_METHODS}
    out["cpu_run_s"] = time.perf_counter() - t0
    return out


def z_diff(card, host, path: str) -> dict:
    """How a card result (numpy, `_geo_host`) of a phase-z path parts from the
    CPU's (Z_CPU_TOL)."""
    tol = Z_CPU_TOL
    r = {}

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            return float("inf")
        top = float(np.abs(b).max()) if b.size else 0.0
        return float(np.abs(a - b).max() / max(top, tol["floor"])) if a.size else 0.0

    def walk(a, b, key):
        if isinstance(a, dict):
            if set(a) != set(b):
                r[key + "#keys"] = (1.0, 0.0)
            for k in a:
                if k in b:
                    walk(a[k], b[k], f"{key}.{k}" if key else k)
        elif path == "learn_plot2d":
            r[key] = (float((a != b).sum()), tol["plot_px"])
        elif key == "boxes" and path == "learn_qr_learned":
            r[key] = (float(np.abs(np.asarray(a) - np.asarray(b)).max()), tol["box_px"])
        elif isinstance(a, (list, tuple)) and a and isinstance(a[0], (float, np.floating)):
            r[key] = (rel(a, b), tol["rel"])
        elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
            r[key] = (rel(a, b), tol["matte_rel"] if path.startswith("learn_info_flow") else tol["rel"])
        elif isinstance(a, np.ndarray):
            r[key] = (float(not (a.shape == b.shape and np.array_equal(a, b))), 0.0)
        elif isinstance(a, float):
            r[key] = (rel(a, b), tol["rel"])
        else:  # strings, texts, None, ints
            r[key] = (float(a != b), 0.0)

    walk(card, host, "")
    return {"ok": all(val <= bound for val, bound in r.values()), "diff": {k: v[0] for k, v in r.items()}}


def learned_gates(train: dict, outs: dict, scene) -> dict:
    """The JAX tests' gates on the learned models' readings: `train` (name
    -> entry.train_learned's readings) and `outs` (phase z's learned_x
    results on `scene`: qr_learned and qr_sr); raises, naming every miss, after
    checking all. Returns the gated numbers."""
    g, missed = {}, {}

    def gate(name, vals, ok):
        g[name] = vals
        if not ok:
            missed[name] = vals

    r = train["espcn"]  # test_training_improves_over_init
    gate("espcn", {"loss_first": r["loss_first"], "loss_last": r["loss_last"]}, r["loss_last"] < r["loss_first"] * 0.8)
    r = train["fsrcnn"]  # test_fsrcnn_beats_bicubic_psnr
    gate("fsrcnn", {k: r[k] for k in ("psnr", "psnr_bicubic", "ssim", "ssim_bicubic")},
         r["psnr"] > r["psnr_bicubic"] + 0.5 and r["ssim"] > r["ssim_bicubic"] - 1e-3)
    r = train["lapsrn"]  # test_lapsrn_training_matches_inference
    gate("lapsrn", {"psnr_before": r["psnr_before"], "psnr_after": r["psnr_after"]},
         r["psnr_after"] > r["psnr_before"] + 1.0)
    r = train["squeezedet"]  # test_train_step_reduces_loss
    gate("squeezedet", {"losses": r["losses"]}, r["losses"][-1] < r["losses"][0])
    r = train["crnn"]  # TestCRNN::test_learns_small_vocab
    gate("crnn", {"strings": r["strings"], "exact": r["exact"], "chars": r["chars"]},
         r["exact"] >= 2 and r["chars"] >= 6)
    r = train["qr_detector"]  # test_center_hits_held_out
    gate("qr_detector", {"held_out_hits": r["held_out_hits"]}, r["held_out_hits"] >= 7)
    o = outs["qr_sr"]  # test_sr_beats_classical_and_bicubic
    texts = scene.qr_tiny_texts
    n = {k: sum(t == w for t, w in zip(o[k], texts)) for k in ("classical", "bicubic", "sr")}
    gate("qr_sr", n, n["classical"] == 0 and n["sr"] >= max(2, n["bicubic"] + 2))
    o = outs["qr_learned"]  # test_scene_decode_beats_classical, test_fallback_on_clean_code
    texts = scene.qr_texts
    n_learned = sum(t == w for t, w in zip(o["texts"], texts))
    n_classical = sum(t == w for t, w in zip(o["classical"], texts))
    gate("qr_learned", {"learned": n_learned, "classical": n_classical, "clean": o["clean"]},
         n_learned > n_classical and n_learned >= 2 and o["clean"] == "FALLBACK1")
    check(not missed, f"learned gates missed: {missed}")
    return g


def numeric_gates(scene, outs: dict) -> dict:
    """tests/test_breadth2/4/6.py's gates of fuzzy and signal on learned_x's
    results (`outs`: method -> result) at the scene's size, the fixtures
    laid into the frame (`entry.LearnedScene`): F0 smooths the noise, keeps
    the smooth wave, inpaints the block; F1 keeps the ramp; the resampled
    sine and ramp; plot2d draws at full value. The gates that read a
    fixture's size (plot2d's lit share, F1 against F0 on a noisy ramp) are
    `fixture_gates`'. Raises, naming every miss. Returns the gated
    numbers."""
    g, missed = {}, {}

    def gate(name, vals, ok):
        g[name] = vals
        if not ok:
            missed[name] = vals

    H, W = scene.sr_frame.shape
    o = _geo_host(outs["f0_filter"])
    gate("f0_filter_smooths", {"var_out": float(o["noise8"].var()), "var_in": float(scene.fuzzy_noise.var())},
         o["noise8"].var() < scene.fuzzy_noise.var() * 0.5)
    gate("f0_roundtrip_on_smooth", {"err": float(np.abs(o["smooth4"] - scene.fuzzy_smooth)[8:-8, 8:-8].max())},
         np.abs(o["smooth4"] - scene.fuzzy_smooth)[8:-8, 8:-8].max() <= 0.02)
    o1 = _geo_host(outs["f1_filter"])
    ramp = scene.fuzzy_ramp
    gate("f1_reconstructs_ramp", {"err": float(np.abs(o1["ramp8"] - ramp)[4:-4, 4:-4].max())},
         np.abs(o1["ramp8"] - ramp)[4:-4, 4:-4].max() < 1e-3)
    o = _geo_host(outs["f0_inpaint"])["out"]
    m = scene.fuzzy_mask
    gate("f0_inpaint", {"err": float(np.abs(o[m] - scene.fuzzy_wave[m]).mean())},
         np.abs(o[m] - scene.fuzzy_wave[m]).mean() < 0.05)
    img = _geo_host(outs["plot2d"])["img"]
    gate("plot2d_frame", {"max": float(img.max()), "lit_rows": int((img > 0).any(1).sum())}, img.max() == 1.0)
    o = _geo_host(outs["resample_signal"])
    n = len(scene.signal)
    t2 = np.linspace(0, n / 100 * 2 * np.pi, 2 * n, endpoint=False)
    gate("resample_preserves_sine", {"err": float(np.abs(o["up"][10:-10] - np.sin(t2)[10:-10]).max())},
         np.abs(o["up"][10:-10] - np.sin(t2)[10:-10]).max() <= 0.02)
    mid = n // 4
    gate("resample_downsample", {"shape": list(o["down"].shape), "mid": float(o["down"][mid])},
         o["down"].shape == (n // 2,) and abs(float(o["down"][mid]) - (2 * mid + 0.5)) < 2.0)
    check(not missed, f"numeric gates missed: {missed}")
    return g


def fixture_gates(device) -> dict:
    """The gates that read their fixture's size, on the tests' own fixtures
    run on `device`: tests/test_breadth4.py's and test_breadth8.py's
    alphamat gates (48 x 48, 24 x 24: at VGA the 150 CG steps do not carry
    a seed across the frame), test_breadth6.py's F1 against F0 on its 32 x
    32 noisy ramp (at VGA F0's border bias weighs less than F1's noise) and
    test_breadth3.py's plot2d lit share at 120 x 160 (a curve lights a
    share that falls as 1 / H). Raises, naming every miss. Returns the
    gated numbers."""
    from opencv_contrib_tpu_torch import alphamat, fuzzy, plot

    g, missed = {}, {}
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    ramp = (0.03 * yy).astype(np.float32)
    noisy = ramp + np.random.default_rng(0).normal(0, 0.02, ramp.shape).astype(np.float32)
    e0 = float(np.abs(_geo_host(fuzzy.f0_filter(_on(noisy, device), radius=8))[4:-4, 4:-4] - ramp[4:-4, 4:-4]).mean())
    e1 = float(np.abs(_geo_host(fuzzy.f1_filter(_on(noisy, device), radius=8))[4:-4, 4:-4] - ramp[4:-4, 4:-4]).mean())
    g["f1_beats_f0_on_ramp"] = {"f0": e0, "f1": e1}
    if not e1 <= e0 + 1e-4:
        missed["f1_beats_f0_on_ramp"] = g["f1_beats_f0_on_ramp"]
    x = np.linspace(0, 2 * np.pi, 100)
    img = _geo_host(plot.plot2d(_on(x, device), _on(np.sin(x), device), shape=(120, 160)))
    ys, _ = np.nonzero(img)
    g["plot2d"] = {"max": float(img.max()), "lit": float((img > 0).mean()), "top_row": int(ys.min())}
    if not (img.max() == 1.0 and 0.005 < g["plot2d"]["lit"] < 0.2 and ys.min() < 30):
        missed["plot2d"] = g["plot2d"]
    img = np.full((48, 48), 0.1, np.float32)  # TestAlphamat::test_two_region_matting
    img[12:36, 12:36] = 0.9
    tri = np.full((48, 48), 0.5, np.float32)
    tri[:6] = tri[-6:] = tri[:, :6] = tri[:, -6:] = 0.0
    tri[20:28, 20:28] = 1.0
    a = _geo_host(alphamat.info_flow(_on(img, device), _on(tri, device)))
    g["two_region"] = {k: float(v) for k, v in (("center", a[24, 24]), ("corner", a[2, 2]), ("inner", a[14, 14]),
                                                 ("band", a[8, 24]))}
    if not (a[24, 24] > 0.95 and a[2, 2] < 0.05 and a[14, 14] > 0.7 and a[8, 24] < 0.3):
        missed["two_region"] = g["two_region"]
    img = np.random.default_rng(0).uniform(size=(24, 24)).astype(np.float32)  # test_known_pixels_pinned
    tri = np.full((24, 24), 0.5, np.float32)
    tri[0], tri[-1] = 1.0, 0.0
    a = _geo_host(alphamat.info_flow(_on(img, device), _on(tri, device)))
    g["known_pinned"] = {"fg_min": float(a[0].min()), "bg_max": float(a[-1].max())}
    if not (a[0].min() > 0.9 and a[-1].max() < 0.1):
        missed["known_pinned"] = g["known_pinned"]
    img = np.zeros((48, 48), np.float32)  # TestNonlocalMatting::test_propagates_across_gap
    img[16:32, 4:16] = 1.0
    img[16:32, 32:44] = 1.0
    tri = np.full((48, 48), 0.5, np.float32)
    tri[20:28, 6:10] = 1.0
    tri[:8] = 0.0
    tri[-8:] = 0.0
    a_loc = _geo_host(alphamat.info_flow(_on(img, device), _on(tri, device)))
    a_nl = _geo_host(alphamat.info_flow_nonlocal(_on(img, device), _on(tri, device), n_samples=512, k=4))
    right = (slice(20, 28), slice(34, 42))
    g["nonlocal"] = {"right_nonlocal": float(a_nl[right].mean()), "right_local": float(a_loc[right].mean()),
                     "top_band": float(a_nl[:6].mean())}
    if not (a_nl[right].mean() > a_loc[right].mean() + 0.05 and a_nl[right].mean() > 0.5 and a_nl[:6].mean() < 0.2):
        missed["nonlocal"] = g["nonlocal"]
    check(not missed, f"fixture gates missed: {missed}")
    return g


def _on(a, device):
    import torch

    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def objdetect_gates(device) -> dict:
    """tests/test_detect_breadth.py::test_decode_and_nms on `device`: the one
    confident anchor decodes to [12, 20, 28, 36] (atol 1e-4); NMS keeps
    boxes 0 and 2 of three."""
    from opencv_contrib_tpu_torch.models import dnn_objdetect as od

    head = np.zeros((6, 6, 1, 7), np.float32)
    head[..., 0] = -8.0
    head[2, 3, 0, 0] = 8.0
    head[2, 3, 0, 5:] = [4.0, -4.0]
    boxes, conf, _ = od.decode(_on(head, device), od.make_anchors((16.0,), device))
    b = _geo_host(boxes)[int(np.argmax(_geo_host(conf)))]
    idx, valid = od.nms(_on([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]], device), _on([0.9, 0.8, 0.7], device),
                        iou_thresh=0.4, top_k=3)
    kept = sorted(set(_geo_host(idx)[_geo_host(valid)].tolist()))
    g = {"box": b.tolist(), "kept": kept}
    check(np.abs(b - np.array([12, 20, 28, 36])).max() <= 1e-4 and kept == [0, 2], f"objdetect gates missed: {g}")
    return g


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


class ChunkWindow:
    """A profiler window of device activity only over the 5k driver's
    chunks k0..k1-1 and all between them (phase o's main run), read by
    step: `marks` (scale_steps' hook) opens the window as chunk k0 starts
    and closes it as chunk k1 starts, and brackets each step inside it by an
    int16 fill (XIMG_MARKER) before and a complex64 fill (CLOSE_MARKER)
    after, which no step launches, so each kernel is read as the innermost
    open step's. Device activity only costs a fraction of recording the
    host's ops too (the 256 run's window of both, before it)."""

    def __init__(self, smoke, k0: int, k1: int):
        torch = smoke.torch
        self.smoke, self.k0, self.k1 = smoke, k0, k1
        self.open_fill = torch.empty(16, dtype=torch.int16, device=smoke.dev)
        self.close_fill = torch.empty(8, dtype=torch.complex64, device=smoke.dev)
        if smoke.marker is None:
            smoke.marker = torch.empty(16, dtype=torch.uint8, device=smoke.dev)
        self.chunks, self.prof, self.wall, self.names, self.host, self.open = 0, None, None, [], [], []

    def marks(self, name: str, start: bool):
        torch = self.smoke.torch
        if name == "chunk" and start:
            if self.chunks == self.k0:
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                time.sleep(WINDOW_PAD_S)
                for _ in range(DIST_MARKERS):
                    self.smoke.marker.zero_()
                self.t0 = time.perf_counter()
            elif self.chunks == self.k1:
                self.close()
            self.chunks += 1
        if self.prof is None or self.wall is not None:
            return
        if start:
            self.names.append(name)
            self.open.append(time.perf_counter())
            self.open_fill.zero_()
        elif self.open:  # a step that opened inside the window
            self.close_fill.zero_()
            self.host.append((name, time.perf_counter() - self.open.pop()))

    def close(self):
        if self.prof is not None and self.wall is None:
            self.smoke.torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            time.sleep(WINDOW_PAD_S)
            self.prof.__exit__(None, None, None)

    def rows(self) -> dict:
        """Per step: calls, host ms, device ms and launches; the kernels
        outside every step; the window's busy share and top device ops."""
        from torch.autograd import DeviceType

        check(self.wall is not None, f"the chunk window never closed: {self.chunks} chunks")
        events = sorted((e.start_ns(), e.name(), e.duration_ns()) for e in self.prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA)
        outside = "(outside the steps)"
        rows = {n: {"count": 0, "host_ms": 0.0, "device_ms": 0.0, "launches": 0}
                for n in sorted(set(SCALE_STEPS.values())) + [outside]}
        for n, dt in self.host:
            rows[n]["count"] += 1
            rows[n]["host_ms"] += dt * 1e3
        stack, opened, closed, seen_start, busy, by_name = [], 0, 0, False, 0, {}
        for _, name, dur in events:
            if FLUSH_KERNEL in name:
                seen_start = True
                continue
            if not seen_start:
                continue
            if XIMG_MARKER in name:
                stack.append(self.names[opened] if opened < len(self.names) else outside)
                opened += 1
                continue
            if CLOSE_MARKER in name:
                closed += 1
                if stack:
                    stack.pop()
                continue
            row = rows[stack[-1] if stack else outside]
            row["device_ms"] += dur / 1e6
            row["launches"] += 1
            busy += dur
            agg = by_name.setdefault(name, [0, 0])
            agg[0] += 1
            agg[1] += dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"wall_s_under_profiler": self.wall, "device_busy_s": busy / 1e9,
                "device_busy_share": busy / 1e9 / self.wall, "device_launches": sum(r["launches"] for r in
                                                                                    rows.values()),
                "markers_whole": opened == closed == len(self.names), "steps": rows,
                "per_step": {n: {"launches_each": r["launches"] / r["count"], "device_ms_each": r["device_ms"] / r["count"],
                                 "host_ms_each": r["host_ms"] / r["count"]} for n, r in rows.items() if r["count"]},
                "top_device": [{"name": k[:80], "count": c, "us": d / 1e3} for k, (c, d) in top]}


def read_window(ev, flush_keys=frozenset()):
    """A profiler window's kernel events (`kernel_events`) without the lead,
    the markers and the L2 flush's kernels, the marker fills it holds, their
    device us, and whether the window counts: every one of its N_MARKERS
    fills survived and some device time was recorded."""
    fills = sum(e.count for e in ev if FLUSH_KERNEL in e.key)
    kept = [e for e in ev if FLUSH_KERNEL not in e.key and LEAD_KERNEL not in e.key and e.key not in flush_keys]
    us = sum(e.self_device_time_total for e in kept)
    return kept, fills, us, fills == N_MARKERS and us > 0


def marker_groups(events):
    """The rows of an `ximg_profile` window's (start_ns, name, duration_ns)
    device events, sorted by start: one a group of consecutive XIMG_MARKER
    fills, holding the device ms, launches and kernels up to the next group
    and the group's fills; the uint8 window markers (FLUSH_KERNEL) and all
    ahead of the first group are counted nowhere."""
    rows, cur, prev_sep = [], None, False
    for _, name, dur in events:
        if XIMG_MARKER in name:
            if not prev_sep:
                cur = {"device_ms": 0.0, "launches": 0, "kernels": {}, "fills": 0}
                rows.append(cur)
            cur["fills"] += 1
            prev_sep = True
            continue
        prev_sep = False
        if cur is None or FLUSH_KERNEL in name:
            continue
        cur["device_ms"] += dur / 1e6
        cur["launches"] += 1
        k = cur["kernels"].setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += dur / 1e6
    return rows


def per_call_launches(ev, iters: int):
    """Launches of one of `iters` calls in a window's events: all, and by
    name those of DEVICE_KERNELS; and whether each of those counts is a
    multiple of iters (every call's kernels present)."""
    out, whole = {"all": sum(e.count for e in ev) / iters}, True
    for k in DEVICE_KERNELS:
        n = sum(e.count for e in ev if is_ours(e.key, k))
        if n:
            out[k] = n / iters
            whole = whole and n % iters == 0
    return out, whole


class Timer:
    """Device times of calls on one card, from torch.profiler."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.marker = self.lead = self.l2_flush = None  # the window markers, their lead and the L2 flush buffer
        self.flush_keys = frozenset()  # the flush's kernels
        self.retaken = []  # the readings of each device_events window taken again

    def wall_s(self, fn):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        return out, time.perf_counter() - t0

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
        kernel events of its window, so each window opens with a wait,
        N_LEAD int8 fills and N_MARKERS uint8 fills; a window that lost any
        of the markers is taken again with a longer wait (`read_window`)."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        if self.marker is None:
            self.marker = torch.empty(16, dtype=torch.uint8, device=self.dev)
        if self.lead is None:
            self.lead = torch.empty(16, dtype=torch.int8, device=self.dev)
        if cold and self.l2_flush is None:
            self._flush_setup()
        fn()
        torch.cuda.synchronize()
        pad, seen = WINDOW_PAD_S, []
        for _ in range(N_WINDOWS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                for _ in range(N_LEAD):
                    self.lead.zero_()
                for _ in range(N_MARKERS):
                    self.marker.zero_()
                for _ in range(iters):
                    if cold:
                        self.flush_l2()
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad)
            ev, fills, us, whole = read_window(kernel_events(prof), self.flush_keys)
            seen.append({"pad_s": pad, "fills": fills, "us": us})
            pad *= 4
            if whole:
                if len(seen) > 1:
                    self.retaken.append(seen[:-1])
                return ev
        raise AssertionError(f"torch.profiler recorded no device time, or not every marker: {seen}")

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
        of DEVICE_KERNELS. A window in which one of those kernels' counts is
        not a multiple of iters lost an event (a trace drops some now and
        then): it is taken again, at most N_WINDOWS times."""
        seen = []
        for _ in range(N_WINDOWS):
            out, whole = per_call_launches(self.device_events(fn, iters), iters)
            if whole:
                if seen:
                    self.retaken.append(seen)
                return out
            seen.append(out)
        raise AssertionError(f"every window lost a kernel event of ours: {seen}")

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


class ScaleRuns(Timer):
    """Phase o's runs beside its main run: tests/test_scale_tpu.py's 256 x
    1,024 reconstruction and the small orbit on the card against the CPU.
    Smoke runs them in a spawned process of its own while the main run
    goes on (`scale_side_runs`): both are host-bound, on cores of their
    own, and share a card that is idle most of the time."""

    @contextlib.contextmanager
    def scale_steps(self, got=None, marks=None):
        """Spans (utils.tracing.trace_span) around the 5k driver's device
        steps, so each step's count, host and device ms and launches can be
        read, and, given a sync log `got`, its host syncs (the yielded dict,
        by step); `marks(step, start)`, when given, is called as each step
        starts and ends (`chunk_window`)."""
        from opencv_contrib_tpu_torch.sfm import pipeline_scale
        from opencv_contrib_tpu_torch.utils.tracing import trace_span

        syncs = {}

        def wrap(fn, name):
            def step(*a, **k):
                i0 = len(got) if got is not None else 0
                if marks is not None:
                    marks(name, True)
                with trace_span(SCALE_PREFIX + name):
                    out = fn(*a, **k)
                if marks is not None:
                    marks(name, False)
                if got is not None:
                    syncs[name] = syncs.get(name, 0) + sum("synchroniz" in str(w.message) for w in got[i0:])
                return out

            return step

        with contextlib.ExitStack() as stack:
            for attr, name in SCALE_STEPS.items():
                stack.enter_context(mock.patch.object(pipeline_scale, attr, wrap(getattr(pipeline_scale, attr), name)))
            yield syncs

    def scale_256(self) -> dict:
        """tests/test_scale_tpu.py's 256 x 1,024 run, once and unprofiled
        (its chunk profile moved into the main run, `ChunkWindow`): its gates
        (>= SFM_SCALE_256_MIN_VIEWS views, the mean reprojection), the
        host syncs and host ms of each step."""
        from opencv_contrib_tpu_torch.sfm import pipeline_scale
        from opencv_contrib_tpu_torch.utils import tracing

        tracks, intr, _ = self.entry.sfm_sequence_scene(*SFM_SCALE_256)

        def run():
            return pipeline_scale.reconstruct_sequential(tracks, intr, **SFM_SCALE_256_RUN)

        tracing.reset_spans()
        with self.sync_log() as got, self.scale_steps(got) as step_syncs:
            rec, wall = self.wall_s(run)
        spans = {k[len(SCALE_PREFIX):]: v for k, v in tracing.span_stats().items() if k.startswith(SCALE_PREFIX)}
        n_reg, mean_px = int(rec.registered.sum()), rec.reprojection_mean_px(tracks)
        check(n_reg >= SFM_SCALE_256_MIN_VIEWS and mean_px <= SFM_MEAN_PX_GATE,
              f"sfm_scale 256 gates: {n_reg} views, mean {mean_px} px")
        return {"views": tracks.n_views, "slots": tracks.slots, "tracks": tracks.n_tracks,
                "settings": SFM_SCALE_256_RUN, "registered": n_reg, "segments": rec.n_segments,
                "reprojection_mean_px": mean_px, "wall_s": wall, "host_span_ms": spans,
                "host_syncs": {**self.sync_summary(got), "by_step": step_syncs}}

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


def scale_side_runs() -> dict:
    """Phase o's 256 x 1,024 run and small card-against-CPU orbit, in the
    spawned process that phase o starts beside its main run (a CUDA
    context of its own); each raises on a missed gate."""
    import torch

    from opencv_contrib_tpu_torch import entry

    side = ScaleRuns(torch, torch.device("cuda", 0))
    side.entry = entry
    t0 = time.perf_counter()
    run_256 = side.scale_256()
    t1 = time.perf_counter()
    small = side.scale_card_vs_cpu()
    return {"run_256": run_256, "small_card_vs_cpu": small, "run_256_s": t1 - t0,
            "small_card_and_cpu_s": time.perf_counter() - t1}


class Smoke(ScaleRuns):
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
        self.x_scene = None  # phase x's detection scene, made once

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
    def orbit_depths(self, shape=(480, 640), intr=KINFU_INTR, n: int = N_ORBIT, sweep: float = ORBIT_SWEEP):
        """Poses (numpy) and depth frames (n, H, W) of the reference orbit,
        rendered on the card."""
        from opencv_contrib_tpu_torch.utils import sdf_scene

        poses = sdf_scene.orbit_poses(n, sweep=sweep)
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
        first frame (KinFu's world is the first camera frame), by
        `rel_error`."""
        from opencv_contrib_tpu_torch.core import se3

        T_gt = se3.inverse(self.card(poses[0])) @ self.card(poses[-1])
        return self.rel_error(se3.inverse(T_gt) @ se3.inverse(T_cw_last))

    def rel_error(self, T):
        """The rotation angle and the translation length of the relative
        transform T (4, 4). Not log_se3's twist: its translation part is NaN
        for rotations of 1e-4 to about 2.4e-4 rad in float32 (the cosine
        rounds to 1), a defect of the JAX package's se3 that the port keeps
        (ROADMAP Queue 3)."""
        from opencv_contrib_tpu_torch.core import se3

        torch = self.torch
        return {"rot": float(torch.linalg.norm(se3.log_so3(T[:3, :3]))), "trans": float(torch.linalg.norm(T[:3, 3]))}

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
    def kinfu_stages(prof, n: int, stages=frozenset({"make_frame", "icp", "integrate", "raycast"})) -> dict:
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
        check(set(out) == set(stages), f"KinFu stage ranges: {sorted(out)}")
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
        z_rows = self.z_kernel_rows()  # phase z's SSIM map and MSE sum, timed here where windows are cheap
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
              "at_the_sr_evaluation_frame": z_rows, "ok": True})

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
        syncs = self.count_syncs(lambda: entry.photometric(deg, cln))
        emit({"phase": "l_photometric", "clip": [T, H, W, 3], "clip_made_s": clip_s, "s_main_path": s,
              "launches": self.launches["photometric"], "launches_per_clip": launches,
              "restoration_gain_db": gain_db,
              "scores": {"psnr": res.psnr, "ssim": res.ssim.tolist(), "gmsd": res.gmsd.tolist(),
                         "nr_score": res.nr_score.tolist(), "features_0": res.features[0].tolist()},
              "plain_path_vs_kernel": vs_plain, "small_card_vs_cpu": vs_cpu,
              "clahe_one_frame_kernel_vs_plain_max_abs": clahe_same_input,
              "ms_per_frame_median": float(np.median(ms)), "ms_per_frame": ms,
              "host_syncs_run": syncs, "host_syncs_per_frame": syncs["in_the_port"] / T,
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

    def kineto_rows(self, prof, wall: float, prefix: str, names, require: bool = True, by_kernel: bool = False) -> dict:
        """A finished profile whose window took `wall` s: device busy time and
        launches, the top device operations, and per span (disjoint, named
        `prefix` + one of `names`; with `require`, each in the window) the
        count, the host ms and the device ms and launches of the kernels whose
        launching op started inside it (op and kernel joined by correlation
        id, as the profiler's own tree joins them); with `by_kernel`, also
        each span's launches and device ms by kernel name."""
        import bisect

        from torch.autograd import DeviceType

        spans, op_start, kernels = [], {}, []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith(prefix):  # a span's device-side copy
                    # a kernel launched by no op (ours, through ctypes) links to nothing: it joins its own launch call
                    kernels.append((e.linked_correlation_id() or e.correlation_id(), name, e.duration_ns()))
            elif name.startswith(prefix):
                spans.append((e.start_ns(), e.end_ns(), name[len(prefix):]))
            elif e.linked_correlation_id() == 0 and not e.is_async():  # an op, not a runtime call
                op_start[e.correlation_id()] = e.start_ns()
        spans.sort()
        starts = [sp[0] for sp in spans]
        outside = "(outside the spans)"
        rows = {n: {"count": 0, "host_ms": 0.0, "device_ms": 0.0, "launches": 0, **({"kernels": {}} if by_kernel else {})}
                for n in sorted(names) + [outside]}
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
            if by_kernel:
                k_row = row["kernels"].setdefault(name, [0, 0.0])
                k_row[0] += 1
                k_row[1] += dur / 1e6
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
        """Phase o: the main run here; the 256 x 1,024 run and the small
        orbit on the card against the CPU in a spawned process of its own
        at the same time (`scale_side_runs`; their seconds under
        run_256_s and small_card_and_cpu_s, side_wait the main run's wait
        for them after it ended)."""
        import multiprocessing

        parts = {}
        t0 = time.perf_counter()
        side = multiprocessing.get_context("spawn").Pool(1)
        try:
            job = side.apply_async(scale_side_runs)
            main_run = self.scale_run()
            parts["main_run"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = job.get(timeout=SCALE_SIDE_TIMEOUT_S)
            parts["side_wait"] = time.perf_counter() - t0
        finally:
            side.terminate()
            side.join()
        run_256, small = got["run_256"], got["small_card_vs_cpu"]
        parts.update(run_256_s=got["run_256_s"], small_card_and_cpu_s=got["small_card_and_cpu_s"])
        emit({"phase": "o_sfm_scale", "main_run": main_run, "run_256": run_256, "small_card_vs_cpu": small,
              "phase_parts_s": parts,
              "tolerance": f"{SFM_SCALE[0]} views: registered >= {SFM_SCALE_MIN_VIEW_SHARE} x views, mean "
                           f"reprojection <= {SFM_MEAN_PX_GATE} px, points on >= {SFM_SCALE_MIN_POINT_SHARE} x "
                           f"tracks, finite, ATE < {SFM_SCALE_ATE} on every {SFM_SCALE_ATE_WINDOW}-view window of "
                           f"the dominant segment; 256: registered >= "
                           f"{SFM_SCALE_256_MIN_VIEWS}, mean <= {SFM_MEAN_PX_GATE} px; small: registered and "
                           f"reg_order equal, mean px within {SFM_SCALE_CPU_TOL['mean_px']}, aligned points within "
                           f"{SFM_SCALE_CPU_TOL['aligned_points']} RMS; no kernel of ours launched",
              "timing": "wall_s: host clock around one synchronised reconstruction (run once, with the sync log "
                        "on); host_span_ms from utils.tracing spans; main_run.chunk_window: device ms, launches and "
                        "top ops by step from one window of device activity over the main run's chunks "
                        f"{SFM_SCALE_CHUNK_WINDOW[0]}-{SFM_SCALE_CHUNK_WINDOW[1] - 1} and all between them, each "
                        "step's kernels between its marker fills (ChunkWindow), "
                        "host ms by step in the window from the host clock; the 256 and small runs went on in a "
                        "spawned process of their own (its own CUDA context on the same card) while the main run "
                        "did",
              "ok": True})

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
        window = ChunkWindow(self, *SFM_SCALE_CHUNK_WINDOW)
        with self.sync_log() as got, self.scale_steps(got, window.marks) as step_syncs:
            try:
                rec, wall = self.counted("sfm_scale", run)
            finally:
                window.close()
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
               "peak_mem_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "profiled_chunks": list(SFM_SCALE_CHUNK_WINDOW), "chunk_window": window.rows()}
        check(n_reg >= SFM_SCALE_MIN_VIEW_SHARE * V and mean_px <= SFM_MEAN_PX_GATE
              and n_pts >= SFM_SCALE_MIN_POINT_SHARE * T and max(ate_windows) < SFM_SCALE_ATE
              and bool(np.isfinite(rec.points[rec.has_point]).all()), f"sfm_scale gates: {out}")
        self.scale_rec = (tracks, rec)  # phase r bundles copies of it on a mesh
        torch.cuda.empty_cache()
        return out

    # ---- (p) -----------------------------------------------------------------
    def rgbd(self):
        out, parts = {}, {}
        for name, fn in (("hash_kinfu", self.hash_kinfu), ("large_kinfu", self.large_kinfu),
                         ("odometry", self.odometry), ("modules", self.rgbd_modules),
                         ("card_vs_cpu", self.rgbd_card_vs_cpu), ("plain_path", self.rgbd_plain_path)):
            t0 = time.perf_counter()
            out[name] = fn()
            parts[name] = time.perf_counter() - t0
        emit({"phase": "p_rgbd", **out, "phase_parts_s": parts,
              "tolerance": f"HashKinFu: every tick tracks, drift rot < {KINFU_DRIFT[0]}, trans < {KINFU_DRIFT[1]} m, "
                           f"blocks < {HASH_CAPACITY}, last raycast hits >= {HASH_HIT_SHARE} of the pixels with "
                           f"depth, 0 host syncs in the port; LargeKinFu: every frame tracks, >= 2 submaps, drift "
                           f"rot < {LARGE_DRIFT[0]}, trans < {LARGE_DRIFT[1]} m, final pose-graph cost <= initial; "
                           f"odometry: ok, icp and merged within {ODO_GATE[0]} rad / {ODO_GATE[1]} m; card vs CPU: "
                           f"{RGBD_CPU_TOL}; plain path within {RGBD_PLAIN_TOL}",
              "timing": "ms: host clock around synchronised calls; device_ms: kernel time from torch.profiler; "
                        "peak memory from torch.cuda.max_memory_allocated over the run",
              "ok": True})

    def vga_orbit(self):
        """orbit_poses(8, sweep=0.5) at VGA with RGBD_INTR, rendered once."""
        if getattr(self, "_vga_orbit", None) is None:
            self._vga_orbit = self.orbit_depths(RGBD_SHAPE, RGBD_INTR)
        return self._vga_orbit

    def textured_gray(self, depth, T_wc, intr):
        """tests/test_rgbd.py:199-203's texture, sin(4x) cos(4y) of the world
        point seen at each pixel (0 where there is no depth)."""
        from opencv_contrib_tpu_torch.rgbd import frame

        torch = self.torch
        T = torch.as_tensor(T_wc, device=depth.device)
        pw = torch.einsum("ij,hwj->hwi", T[:3, :3], frame.depth_to_points(depth, intr)) + T[:3, 3]
        return torch.sin(4.0 * pw[..., 0]) * torch.cos(4.0 * pw[..., 1]) * (depth > 0)

    def peak_gb(self, fn):
        """fn's result, and the peak device memory during it above what was
        held before it, in GB."""
        torch = self.torch
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        return res, (torch.cuda.max_memory_allocated() - held) / 2 ** 30

    def hash_kinfu(self) -> dict:
        from torch.profiler import ProfilerActivity, profile

        from opencv_contrib_tpu_torch.rgbd import hash_tsdf, kinfu

        torch, entry = self.torch, self.entry
        poses, depths = self.vga_orbit()
        kw = dict(frame_shape=RGBD_SHAPE, voxel_size=HASH_VOXEL, capacity=HASH_CAPACITY)
        entry.hash_kinfu_track(depths[:2], RGBD_INTR, **kw)  # warm-up: cuSOLVER, the allocator
        (track, s), peak = self.peak_gb(lambda: self.counted("hash_kinfu",
                                                             lambda: entry.hash_kinfu_track(depths, RGBD_INTR, **kw)))
        ok, n_active = track.ok.cpu().tolist(), track.n_active.cpu().tolist()
        check(all(ok), f"HashKinFu lost tracking: {ok}")
        drift = self.drift(poses, track.T_cw[-1])
        check(drift["rot"] < KINFU_DRIFT[0] and drift["trans"] < KINFU_DRIFT[1], f"HashKinFu drift {drift}")
        check(max(n_active) < HASH_CAPACITY, f"HashKinFu pool full: {n_active}")
        intr = self.card(RGBD_INTR)
        _, _, valid = hash_tsdf.raycast(track.volume, intr, track.T_cw[-1], shape=RGBD_SHAPE)
        has = depths[-1] > 0
        hit = float((valid & has).sum()) / float(has.sum())
        check(hit >= HASH_HIT_SHARE, f"HashKinFu last raycast hits {hit} of the pixels with depth")
        ticks = len(depths) - 1
        getab = self.launches["hash_kinfu"]["grid_reduce_vec"] / ticks
        check(getab == sum(kinfu.KinFuParams.icp_iterations), f"getAb launches per tick {getab}")
        syncs = self.count_syncs(lambda: entry.hash_kinfu_track(depths, RGBD_INTR, **kw))
        check(syncs["in_the_port"] == 0, f"HashKinFu ticks synchronised the host: {syncs}")

        # ms per tick: a tracker past frames 0-1, N_HASH_TIMED unsynchronised ticks, then profiled ticks
        p = kinfu.KinFuParams(intr=np.asarray(RGBD_INTR, np.float32), frame_shape=RGBD_SHAPE,
                              volume_resolution=(512,) * 3, volume_size=HASH_VOXEL * 512)
        kf = kinfu.HashKinFu(p, capacity=HASH_CAPACITY)
        kf.update(depths[0])
        kf.update(depths[1])
        order = list(range(2, len(depths))) + list(range(len(depths) - 2, 1, -1))  # out and back along the orbit
        frames = [depths[i] for i in order[:N_HASH_TIMED]]
        _, wall = self.wall_s(lambda: [kf.update(f, sync=False) for f in frames])
        check(bool(kf.last_ok), "HashKinFu timed ticks lost tracking")
        prof_frames = [depths[i] for i in order[N_HASH_TIMED:N_HASH_TIMED + N_HASH_PROFILED]]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_prof = self.wall_s(lambda: [kf.update(f, sync=False) for f in prof_frames])
        ev = kernel_events(prof)
        busy_us = sum(e.self_device_time_total for e in ev)
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
        return {"frames": [len(depths), *RGBD_SHAPE], "voxel_m": HASH_VOXEL, "capacity": HASH_CAPACITY,
                "s_entry_run": s, "ms_per_frame_entry": s / len(depths) * 1e3, "ms_per_tick": wall / len(frames) * 1e3,
                "device_ms_per_tick": busy_us / 1e3 / len(prof_frames), "device_busy_share": busy_us * 1e-6 / wall_prof,
                "stages_per_tick": self.kinfu_stages(prof, len(prof_frames), HASH_STAGES),
                "top_device": [{"name": e.key[:80], "count": e.count, "us": e.self_device_time_total} for e in top],
                "active_blocks": n_active, "raycast_hit_share": hit, "drift": drift, "ok": ok,
                "launches": self.launches["hash_kinfu"], "getab_per_tick": getab, "host_syncs_run": syncs,
                "host_syncs_per_tick": syncs["in_the_port"] / ticks, "peak_mem_gb": peak}

    def large_kinfu(self) -> dict:
        from opencv_contrib_tpu_torch.rgbd import kinfu, submap

        entry = self.entry
        poses, depths = self.orbit_depths(RGBD_SHAPE, RGBD_INTR, *LARGE_ORBIT)
        kw = dict(frame_shape=RGBD_SHAPE, **LARGE_PARAMS)
        entry.large_kinfu_track(depths[:2], RGBD_INTR, **kw)  # warm-up
        (out, s), peak = self.peak_gb(lambda: self.counted("large_kinfu",
                                                           lambda: entry.large_kinfu_track(depths, RGBD_INTR, **kw)))
        check(all(out.ok), f"LargeKinFu lost tracking: {out.ok}")
        check(out.n_submaps[-1] >= 2, f"LargeKinFu made {out.n_submaps[-1]} submaps")
        drift = self.drift(poses, out.T_cw[-1])
        check(drift["rot"] < LARGE_DRIFT[0] and drift["trans"] < LARGE_DRIFT[1], f"LargeKinFu drift {drift}")
        getab = self.launches["large_kinfu"]["grid_reduce_vec"] / (len(depths) - 1)
        check(getab == sum(kinfu.KinFuParams.icp_iterations), f"getAb launches per frame {getab}")
        lk = out.tracker
        i, j = 0, len(lk.submaps) - 1  # tests/test_rgbd_scale.py:96-101: first -> last from the current estimates
        lk.add_loop_constraint(i, j, submap._host_mul(lk.submaps[i].T_ws, lk.submaps[j].T_ws, invert_a=True), 2.0)
        (c0, c1), s_opt = self.wall_s(lambda: lk.optimize_pose_graph(n_iters=15))
        check(np.isfinite(c0) and c1 <= c0, f"pose graph costs {c0} -> {c1}")
        _, s_opt2 = self.wall_s(lambda: lk.optimize_pose_graph(n_iters=15))  # warm
        syncs_opt = self.count_syncs(lambda: lk.optimize_pose_graph(n_iters=15))
        syncs = self.count_syncs(lambda: entry.large_kinfu_track(depths, RGBD_INTR, **kw))
        return {"frames": [len(depths), *RGBD_SHAPE], "params": LARGE_PARAMS, "s": s,
                "ms_per_frame": s / len(depths) * 1e3, "submaps_after_frame": out.n_submaps, "drift": drift,
                "pose_graph_costs": [c0, c1], "s_optimize_15": [s_opt, s_opt2], "host_syncs_optimize": syncs_opt,
                "launches": self.launches["large_kinfu"], "getab_per_frame": getab, "host_syncs_run": syncs,
                "host_syncs_per_frame": syncs["in_the_port"] / len(depths), "peak_mem_gb": peak}

    def odometry(self) -> dict:
        from torch.profiler import ProfilerActivity, profile

        from opencv_contrib_tpu_torch.core import se3

        torch, entry = self.torch, self.entry
        poses, depths = self.vga_orbit()
        intr = self.card(RGBD_INTR)
        g0, g1 = (self.textured_gray(depths[k], poses[k], intr) for k in (0, 1))
        args = (g1, depths[1], g0, depths[0], RGBD_INTR)  # src = frame 1, dst = frame 0
        T_gt = se3.inverse(self.card(poses[0])) @ self.card(poses[1])
        rows = {}
        for method in ODO_METHODS:
            entry.rgbd_odometry(*args, method=method)  # warm-up
            (T, ok), s = self.counted("odometry" if method == "merged" else "odometry_" + method,
                                      lambda: entry.rgbd_odometry(*args, method=method))
            launches = self.launches["odometry" if method == "merged" else "odometry_" + method]
            err = self.rel_error(T_gt @ se3.inverse(T))
            check(ok, f"odometry {method}: not ok")
            if method != "rgbd":
                check(err["rot"] < ODO_GATE[0] and err["trans"] < ODO_GATE[1], f"odometry {method}: {err}")
            check(all(launches[k] == v for k, v in ODO_LAUNCHES[method].items()),
                  f"odometry {method} launches {launches}")
            wall = [self.wall_s(lambda: entry.rgbd_odometry(*args, method=method))[1] for _ in range(N_ODO_TIMED)]
            rows[method] = {"error_vs_truth": err, "ms_per_call": float(np.median(wall)) * 1e3,
                            "ms_first_counted": s * 1e3, "launches": launches,
                            "host_syncs_call": self.count_syncs(lambda: entry.rgbd_odometry(*args, method=method))}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = self.wall_s(lambda: entry.rgbd_odometry(*args, method="merged"))
        ev = kernel_events(prof)
        busy_us = sum(e.self_device_time_total for e in ev)
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
        rows["merged"]["profile"] = {
            "wall_ms_under_profiler": wall * 1e3, "device_ms": busy_us / 1e3,
            "device_busy_share": busy_us * 1e-6 / wall,
            "device_launches": sum(e.count for e in ev),
            "top_device": [{"name": e.key[:80], "count": e.count, "us": e.self_device_time_total} for e in top]}
        return {"pair": "orbit_poses(8, sweep=0.5) frames 1 -> 0, textured", "shape": list(RGBD_SHAPE), **rows}

    def rgbd_modules(self) -> dict:
        from opencv_contrib_tpu_torch.core import se3
        from opencv_contrib_tpu_torch.ops.cuda import scan
        from opencv_contrib_tpu_torch.rgbd import colored_tsdf, depth_utils, normals

        torch = self.torch
        poses, depths = self.vga_orbit()
        intr = self.card(RGBD_INTR)
        rgb = self.card(np.random.default_rng(5).uniform(0, 1, RGBD_SHAPE + (3,)))
        T_cw = [se3.inverse(self.card(p)) for p in poses]
        out = {}

        def timed(name, fn):
            fn()  # warm-up
            res, s = self.wall_s(fn)
            out[name + "_ms"] = s * 1e3
            return res

        def colored():
            vol = colored_tsdf.create(COLORED_RES, COLORED_SIZE, device=self.dev)
            for k in (0, 1):
                vol = colored_tsdf.integrate(vol, depths[k], rgb, intr, T_cw[k])
            return vol

        vol, out["colored_integrate2_peak_gb"] = self.peak_gb(colored)
        (pts, _, col, valid), out["raycast_colored_peak_gb"] = self.peak_gb(
            lambda: colored_tsdf.raycast_colored(vol, intr, T_cw[1], shape=RGBD_SHAPE))
        share = float((valid & (depths[1] > 0)).sum()) / float((depths[1] > 0).sum())
        check(share > 0.5 and bool(torch.isfinite(col).all()) and float(col.max()) <= 1.0,
              f"raycast_colored: hit share {share}")
        out["colored_hit_share"] = share
        timed("colored_integrate", lambda: colored_tsdf.integrate(vol, depths[1], rgb, intr, T_cw[1]))
        timed("raycast_colored", lambda: colored_tsdf.raycast_colored(vol, intr, T_cw[1], shape=RGBD_SHAPE))
        del vol
        intr_rgb = self.card([410.0, 405.0, 318.0, 244.0, 0, 0, 0, 0, 0])
        T_rgb = se3.exp_se3(self.card([0.01, 0.02, -0.01, 0.05, -0.01, 0.02]))
        reg = timed("register_depth", lambda: depth_utils.register_depth(depths[0], intr, intr_rgb, T_rgb))
        out["register_share"] = float((reg > 0).float().mean())
        plane, mask = timed("extract_planes", lambda: depth_utils.extract_planes(
            depths[0], intr, torch.Generator().manual_seed(0)))
        out["plane"], out["plane_share"] = plane.cpu().tolist(), float(mask.float().mean())
        check(abs(float(torch.linalg.norm(plane[:3])) - 1.0) < 1e-4 and out["plane_share"] > 0.05,
              f"extract_planes: {out['plane']}, {out['plane_share']}")
        depth_utils.clean_depth(depths[0], intr)  # warm-up
        cleaned, s = self.counted("clean_depth", lambda: depth_utils.clean_depth(depths[0], intr))
        out["clean_depth_ms"], out["clean_depth_launches"] = s * 1e3, self.launches["clean_depth"]
        check(bool(torch.isfinite(cleaned).all()) and bool((cleaned[depths[0] == 0] == 0).all()), "clean_depth")
        # clean_depth's summed-area tables are the integral kernel's, at the padded frame's shape
        x = torch.nn.functional.pad(depths[0], (1, 1, 1, 1))
        ii, ref = scan.integral_padded(x), scan.integral_padded_plain(x)
        err, top = float((ii - ref).abs().max()), float(ref.abs().max())
        check(err <= 2e-6 * top, f"integral at {tuple(x.shape)}: {err} > 2e-6 * {top}")
        out["integral_padded"] = {"shape": list(x.shape), "max_abs_err": err, "max_abs": top}
        for m in normals.METHODS:
            n = timed("normals_" + m, lambda: normals.rgbd_normals(depths[0], intr, method=m))
            share = float((n.abs().sum(-1) > 0).float().mean())
            check(share > 0.3 and bool(torch.isfinite(n).all()), f"normals {m}: valid share {share}")
        return out

    def rgbd_card_vs_cpu(self) -> dict:
        """The paths of this phase at 120x160 on the card and on the CPU."""
        from opencv_contrib_tpu_torch.core import se3
        from opencv_contrib_tpu_torch.ops.cuda import scan
        from opencv_contrib_tpu_torch.rgbd import colored_tsdf, depth_utils, normals

        torch, entry = self.torch, self.entry
        cpu, tol, out = torch.device("cpu"), RGBD_CPU_TOL, {}
        sk = dict(frame_shape=RGBD_SMALL_SHAPE)

        def both(fn):
            return fn(self.dev), fn(cpu)

        def pose_diff(a, b):
            return float((a.cpu() - b.cpu()).abs().max())

        poses, small = self.orbit_depths(RGBD_SMALL_SHAPE, RGBD_SMALL_INTR)
        small = small.cpu()  # both devices track the card's renders
        hc, hh = both(lambda d: entry.hash_kinfu_track(small[:5].to(d), RGBD_SMALL_INTR, voxel_size=3.2 / 96,
                                                       capacity=4096, device=d, **sk))
        out["hash_kinfu_pose"] = max(pose_diff(a, b) for a, b in zip(hc.T_cw, hh.T_cw))
        nc, nh = hc.n_active.cpu().tolist(), hh.n_active.tolist()
        out["hash_kinfu_blocks"] = [nc, nh]
        check(bool(hc.ok.all()) and bool(hh.ok.all()) and out["hash_kinfu_pose"] <= tol["hash_pose"]
              and all(abs(a - b) <= max(2, tol["blocks"] * b) for a, b in zip(nc, nh)), f"HashKinFu card vs CPU {out}")

        _, wide = self.orbit_depths(RGBD_SMALL_SHAPE, RGBD_SMALL_INTR, *LARGE_ORBIT)
        wide = wide[:6].cpu()
        lc, lh = both(lambda d: entry.large_kinfu_track(wide.to(d), RGBD_SMALL_INTR, device=d,
                                                        max_dist_from_center=0.2, **sk))
        out["large_kinfu_pose"] = max(pose_diff(a, b) for a, b in zip(lc.T_cw, lh.T_cw))
        out["large_kinfu_submaps"] = [lc.n_submaps, lh.n_submaps]
        check(all(lc.ok) and all(lh.ok) and lc.n_submaps == lh.n_submaps and lc.n_submaps[-1] >= 2
              and out["large_kinfu_pose"] <= tol["large_pose"], f"LargeKinFu card vs CPU {out}")

        gray = [self.textured_gray(small[k].to(self.dev), poses[k], self.card(RGBD_SMALL_INTR)).cpu() for k in (0, 1)]
        for m in ODO_METHODS:
            (Tc, okc), (Th, okh) = both(lambda d: entry.rgbd_odometry(gray[1], small[1], gray[0], small[0],
                                                                      RGBD_SMALL_INTR, method=m, device=d))
            out["odometry_" + m] = pose_diff(Tc, Th)
            check(okc == okh and out["odometry_" + m] <= tol["odometry_T"], f"odometry {m} card vs CPU {out}")

        it = {d: torch.as_tensor(np.asarray(RGBD_SMALL_INTR, np.float32), device=d) for d in (self.dev, cpu)}
        T_cw = [se3.inverse(torch.as_tensor(p)) for p in poses[:2]]
        rgb = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, RGBD_SMALL_SHAPE + (3,)).astype(np.float32))

        def colored(d):
            vol = colored_tsdf.create((64, 64, 64), 3.2, device=d)
            for k in (0, 1):
                vol = colored_tsdf.integrate(vol, small[k].to(d), rgb.to(d), it[d], T_cw[k].to(d))
            return vol, colored_tsdf.raycast_colored(vol, it[d], T_cw[1].to(d), shape=RGBD_SMALL_SHAPE)

        (vc, rc), (vh, rh) = both(colored)
        wdiff = (vc.base.weight.cpu() != vh.base.weight).float().mean().item()
        cdiff = (vc.color.cpu() - vh.color).abs().amax(-1)
        out["colored"] = {"weight_differs_share": wdiff, "color_over_tol_share": float((cdiff > tol["colors"]).float()
                                                                                       .mean()),
                          "raycast_valid_differs": int((rc[3].cpu() != rh[3]).sum()),
                          "raycast_color_max": float((rc[2].cpu() - rh[2])[rc[3].cpu() & rh[3]].abs().max())}
        check(wdiff <= tol["voxel_share"] and out["colored"]["color_over_tol_share"] <= tol["voxel_share"]
              and out["colored"]["raycast_valid_differs"] <= max(2, tol["pixel_share"] * rh[3].numel()),
              f"colored TSDF card vs CPU {out['colored']}")

        d0 = {d: small[0].to(d) for d in (self.dev, cpu)}
        intr_rgb = np.array([130.0, 128.0, 78.0, 62.0, 0, 0, 0, 0, 0], np.float32)
        T_rgb = se3.exp_se3(torch.tensor([0.01, 0.02, -0.01, 0.05, -0.01, 0.02]))
        rc_, rh_ = both(lambda d: depth_utils.register_depth(d0[d], it[d], torch.as_tensor(intr_rgb, device=d),
                                                             T_rgb.to(d)))
        out["register_differs"] = int((rc_.cpu() != rh_).sum())
        (pc, mc), (ph, mh) = both(lambda d: depth_utils.extract_planes(d0[d], it[d], torch.Generator().manual_seed(3)))
        out["plane"] = float((pc.cpu() - ph).abs().max())
        out["plane_mask_differs"] = int((mc.cpu() != mh).sum())
        check(out["register_differs"] <= max(2, 1e-4 * rh_.numel()) and out["plane"] <= tol["plane"]
              and out["plane_mask_differs"] <= max(2, 1e-4 * mh.numel()), f"depth utils card vs CPU {out}")
        # clean_depth: the card's box sums are differences of the integral kernel's tables, which sum in their own
        # order: the depth may move by 4x the largest table difference (of the z channel, the largest table)
        cc, ch = both(lambda d: depth_utils.clean_depth(d0[d], it[d]))
        x = torch.nn.functional.pad(d0[self.dev], (1, 1, 1, 1))
        table = float((scan.integral_padded(x) - scan.integral_padded_plain(x)).abs().max())
        out["clean_depth"] = {"max_diff": float((cc.cpu() - ch).abs().max()), "table_diff": table}
        check(out["clean_depth"]["max_diff"] <= tol["clean_depth"] + 4 * table, f"clean_depth card vs CPU {out}")
        with plain_path():
            cp = depth_utils.clean_depth(d0[self.dev], it[self.dev])
        out["clean_depth"]["plain_path_vs_cpu"] = float((cp.cpu() - ch).abs().max())
        check(out["clean_depth"]["plain_path_vs_cpu"] <= tol["clean_depth"], f"clean_depth plain vs CPU {out}")
        # normals; FALS within 1e-4 + 2 eps kappa (tests/test_torch_rgbd_odometry.py: kappa is 3e3-3e4 here)
        A = normals._fals_system(d0[cpu], it[cpu])[0].double().numpy()
        kappa = np.linalg.cond(np.where(np.asarray(small[0] > 0)[..., None, None], A, np.eye(3)))
        for m in normals.METHODS:
            nc_, nh_ = both(lambda d: normals.rgbd_normals(d0[d], it[d], method=m))
            diff = (nc_.cpu() - nh_).abs().amax(-1).numpy()
            bound = tol["normals"] + (2 * 2.0 ** -24 * kappa if m == "fals" else 0.0)
            valid = (nh_.abs().sum(-1) > 0).numpy()
            out["normals_" + m] = {"max_diff": float(diff[valid].max()), "over_bound": int((diff > bound)[valid].sum()),
                                   "valid_differs": int(((nc_.cpu().abs().sum(-1) > 0).numpy() != valid).sum())}
            check(out["normals_" + m]["over_bound"] == 0 and out["normals_" + m]["valid_differs"] <= 2,
                  f"normals {m} card vs CPU {out['normals_' + m]}")
        return out

    def rgbd_plain_path(self) -> dict:
        """One HashKinFu tick and one merged odometry at VGA with getAb and
        pyrdown swapped for their plain versions, against the kernel path."""
        from opencv_contrib_tpu_torch.rgbd import kinfu

        entry = self.entry
        poses, depths = self.vga_orbit()

        def tick():
            p = kinfu.KinFuParams(intr=np.asarray(RGBD_INTR, np.float32), frame_shape=RGBD_SHAPE,
                                  volume_resolution=(512,) * 3, volume_size=HASH_VOXEL * 512)
            kf = kinfu.HashKinFu(p, capacity=HASH_CAPACITY)
            kf.update(depths[0])
            check(kf.update(depths[1]), "HashKinFu tick lost tracking")
            return kf.T_cw

        intr = self.card(RGBD_INTR)
        g0, g1 = (self.textured_gray(depths[k], poses[k], intr) for k in (0, 1))

        def odo():
            return entry.rgbd_odometry(g1, depths[1], g0, depths[0], RGBD_INTR, method="merged")[0]

        kernel = (tick(), odo())
        with plain_path():
            plain = (tick(), odo())
        out = {"hash_kinfu_tick_pose": float((kernel[0] - plain[0]).abs().max()),
               "odometry_merged_T": float((kernel[1] - plain[1]).abs().max())}
        check(max(out.values()) <= RGBD_PLAIN_TOL, f"plain path differs from the kernel path: {out}")
        return out

    # ---- (q) -----------------------------------------------------------------
    def remainder(self):
        out, parts = {}, {}
        for name, fn in (("tum", self.tum_disk), ("dynafu", self.dynafu), ("flow", self.flow_remainder),
                         ("card_vs_cpu", self.remainder_card_vs_cpu)):
            t0 = time.perf_counter()
            out[name] = fn()
            parts[name] = time.perf_counter() - t0
        emit({"phase": "q_tum_dynafu_flow", **out, "phase_parts_s": parts,
              "tolerance": f"TUM: decoded depths equal the written quanta, the C++ unfilter equal to the numpy "
                           f"version, every frame tracked, ATE < {TUM_ATE_GATE} m, drift rot < {KINFU_DRIFT[0]}, "
                           f"trans < {KINFU_DRIFT[1]} m; DynaFu: every update ok, bump > {DYNAFU_BUMP_GATE} m; flow: "
                           f"interior EPE < {FLOW_EXTRA_EPE_GATE} px, plain path within {FLOW_PLAIN_TOL} px; card "
                           f"vs CPU: {REMAINDER_CPU_TOL}",
              "timing": "ms: host clock around synchronised calls; frames/s and decode ms on the host clock",
              "ok": True})

    def tum_disk(self) -> dict:
        import tempfile

        from opencv_contrib_tpu_torch.rgbd import kinfu
        from opencv_contrib_tpu_torch.utils import datasets, native, png
        from opencv_contrib_tpu_torch.utils.tum_export import write_tum_sequence

        torch, entry = self.torch, self.entry
        t0 = time.perf_counter()
        png.unfilter_lib()
        host_build_s = time.perf_counter() - t0
        poses, depths = self.orbit_depths(TUM_SHAPE, TUM_FR1_INTR, TUM_FRAMES, TUM_SWEEP)
        depths_np = depths.cpu().numpy()
        quanta = np.clip(depths_np.astype(np.float64) * 5000.0, 0, 65535).astype(np.uint16)  # the writer's rule
        with tempfile.TemporaryDirectory(prefix="tum_") as root:
            t0 = time.perf_counter()
            write_tum_sequence(root, depths_np, poses)
            write_s = time.perf_counter() - t0
            seq = datasets.load_tum(root)
            paths = [(os.path.join(root, p[1]), os.path.join(root, p[3])) for p in seq.pairs]
            # the codec: every depth PNG decodes to the written quanta
            t0 = time.perf_counter()
            for i, (rgb_path, depth_path) in enumerate(paths):
                native.decode_png(rgb_path)
                check(np.array_equal(png.read(depth_path), quanta[i]), f"depth PNG {i} does not decode to its quanta")
            decode_ms = (time.perf_counter() - t0) / len(paths) * 1e3
            # the C++ unfilter against the numpy version, one PNG of each filter type
            unfilter = {}
            for ftype in range(5):
                data = png.encode(quanta[0], filter=ftype)
                raw = zlib.decompress(b"".join(body for t, body in png._chunks(data) if t == b"IDAT"))
                rowbytes = 2 * TUM_SHAPE[1]
                t0 = time.perf_counter()
                fast = png.unfilter(raw, TUM_SHAPE[0], rowbytes, 2)
                cpp_ms = (time.perf_counter() - t0) * 1e3
                check(np.array_equal(fast, png.unfilter_numpy(raw, TUM_SHAPE[0], rowbytes, 2)),
                      f"C++ unfilter differs from numpy on filter {ftype}")
                unfilter[png.FILTERS[ftype]] = {"bytes": len(data), "cpp_ms": cpp_ms}
            # the loader alone: frames/s, and its depths equal the quanta over 5000
            t0 = time.perf_counter()
            frames = list(native.TumLoader(root, n_threads=4, prefetch=8))
            loader_s = time.perf_counter() - t0
            check(len(frames) == TUM_FRAMES and all(np.array_equal(f[3], quanta[i].astype(np.float32) / 5000.0)
                                                    for i, f in enumerate(frames)), "loader frames differ")
            kw = dict(intr=TUM_FR1_INTR, n_threads=4, prefetch=8, **TUM_KINFU)
            entry.tum_kinfu(root, **kw)  # warm-up: cuSOLVER, the allocator
            res, s_disk = self.counted("tum_kinfu", lambda: entry.tum_kinfu(root, **kw))
            syncs = self.count_syncs(lambda: entry.tum_kinfu(root, **kw))
        check(res.frames == TUM_FRAMES and res.lost == [], f"TUM KinFu lost frames {res.lost}")
        check(res.ate < TUM_ATE_GATE, f"TUM KinFu ATE {res.ate} m")
        drift = self.drift(poses, self.torch.linalg.inv(self.card(res.poses[-1])))
        check(drift["rot"] < KINFU_DRIFT[0] and drift["trans"] < KINFU_DRIFT[1], f"TUM KinFu drift {drift}")
        getab = self.launches["tum_kinfu"]["grid_reduce_vec"] / (TUM_FRAMES - 1)
        check(getab == sum(kinfu.KinFuParams.icp_iterations), f"getAb launches per tick {getab}")
        # the same frames from memory (on the card already)
        mem_kw = dict(TUM_KINFU, frame_shape=TUM_SHAPE)
        (track, s_mem) = self.wall_s(lambda: entry.kinfu_track(depths, TUM_FR1_INTR, **mem_kw))
        check(bool(track.ok.all()), "TUM frames from memory lost tracking")
        mem_pose = float((torch.linalg.inv(track.T_cw[-1]).cpu() - torch.from_numpy(res.poses[-1])).abs().max())
        return {"frames": [TUM_FRAMES, *TUM_SHAPE], "intr": TUM_FR1_INTR, "kinfu": {k: list(v) if isinstance(v, tuple)
                                                                                     else v for k, v in TUM_KINFU.items()},
                "host_unfilter_build_s": host_build_s, "write_s": write_s, "decode_ms_per_frame": decode_ms,
                "unfilter": unfilter, "loader_frames_per_s": TUM_FRAMES / loader_s,
                "ate_m": res.ate, "drift": drift, "lost": res.lost, "s_from_disk": s_disk,
                "ms_per_tick_from_disk": s_disk / TUM_FRAMES * 1e3, "s_from_memory": s_mem,
                "ms_per_tick_from_memory": s_mem / TUM_FRAMES * 1e3, "last_pose_disk_vs_memory": mem_pose,
                "launches": self.launches["tum_kinfu"], "getab_per_tick": getab, "host_syncs_run": syncs,
                "host_syncs_per_tick": syncs["in_the_port"] / TUM_FRAMES}

    def bump_depths(self, shape, scale: int, n: int):
        """tests/test_rgbd_extras.py:163-166's growing bump at `scale` times
        its 60x80, sampled at n frames: (n, H, W) on the card."""
        torch = self.torch
        yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
        out = []
        for t in np.linspace(0.0, 1.0, n):
            bump = 0.2 * t * np.exp(-((yy - 30 * scale) ** 2 + (xx - 40 * scale) ** 2) / (2 * (8.0 * scale) ** 2))
            out.append((1.5 - bump).astype(np.float32))
        return torch.from_numpy(np.stack(out)).to(self.dev)

    @staticmethod
    def bump_gate(warped, valid, scale: int) -> float:
        """The rim's depth minus the centre's in the live render
        (tests/test_rgbd_extras.py:180-185, regions scaled)."""
        c = slice(26 * scale, 34 * scale), slice(36 * scale, 44 * scale)
        r = slice(5 * scale, 15 * scale), slice(5 * scale, 15 * scale)
        center, rim = warped[c][..., 2][valid[c]], warped[r][..., 2][valid[r]]
        check(center.numel() > 0 and rim.numel() > 0, "DynaFu render: no valid pixel in the gate's regions")
        return float(rim.mean() - center.mean())

    def dynafu(self) -> dict:
        from opencv_contrib_tpu_torch.rgbd import warpfield

        torch, entry = self.torch, self.entry
        intr = [70.0 * DYNAFU_SCALE, 70.0 * DYNAFU_SCALE, 40.0 * DYNAFU_SCALE, 30.0 * DYNAFU_SCALE]
        depths = self.bump_depths(DYNAFU_SHAPE, DYNAFU_SCALE, DYNAFU_FRAMES)
        entry.dynafu_track(depths[:2], intr, **DYNAFU_PARAMS)  # warm-up
        fit_s = []
        fit = warpfield.fit

        def timed_fit(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit(*a, **k)
            torch.cuda.synchronize()
            fit_s.append(time.perf_counter() - t0)
            return res

        (track, s), peak = self.peak_gb(lambda: self.counted("dynafu",
                                                             lambda: entry.dynafu_track(depths, intr, **DYNAFU_PARAMS)))
        check(all(track.ok), f"DynaFu updates not ok: {track.ok}")
        warped, valid = track.tracker.render_live()
        gate = self.bump_gate(warped, valid, DYNAFU_SCALE)
        check(gate > DYNAFU_BUMP_GATE, f"DynaFu bump pulled by {gate} m")
        with mock.patch.object(warpfield, "fit", timed_fit):
            _, s_fit_run = self.wall_s(lambda: entry.dynafu_track(depths, intr, **DYNAFU_PARAMS))
        syncs = self.count_syncs(lambda: entry.dynafu_track(depths, intr, **DYNAFU_PARAMS))
        return {"frames": [DYNAFU_FRAMES, *DYNAFU_SHAPE], "intr": intr,
                "params": {k: list(v) if isinstance(v, tuple) else v for k, v in DYNAFU_PARAMS.items()},
                "ok": track.ok, "bump_m": gate, "s": s, "ms_per_frame": s / DYNAFU_FRAMES * 1e3,
                "fit_ms_per_update": float(np.mean(fit_s)) * 1e3, "fit_share": sum(fit_s) / s_fit_run,
                "s_with_fit_synced": s_fit_run, "peak_mem_gb": peak, "launches": self.launches["dynafu"],
                "host_syncs_run": syncs, "host_syncs_per_frame": syncs["in_the_port"] / DYNAFU_FRAMES}

    def flow_remainder(self) -> dict:
        from opencv_contrib_tpu_torch.flow import dis, gpc, motempl

        torch, entry = self.torch, self.entry
        I0, I1, gt = entry.flow_pair()
        gt_c = self.card(gt)
        for m in FLOW_EXTRA:  # warm-up
            entry.dense_flow(I0, I1, m)
        split = {}

        def main_path():
            out = {}
            for m in FLOW_EXTRA:
                before = self.kern.launches()
                out[m] = entry.dense_flow(I0, I1, m)
                after = self.kern.launches()
                split[m] = {k: after[k] - before[k] for k in PATH_KERNELS["dense_flow_extra"]}
            return out

        flows, s = self.counted("dense_flow_extra", main_path)
        check(split == FLOW_EXTRA_LAUNCHES, f"dense-flow remainder launches {split}, expected {FLOW_EXTRA_LAUNCHES}")
        with plain_path():
            plain = {m: entry.dense_flow(I0, I1, m) for m in ("deepflow", "rlof")}
        res = {}
        for m in FLOW_EXTRA:
            f = flows[m]
            check(f.shape == gt_c.shape and bool(torch.isfinite(f).all()), f"{m}: flow shape / finite")
            epe = float(dis.epe(f[8:-8, 8:-8], gt_c[8:-8, 8:-8]))
            check(epe < FLOW_EXTRA_EPE_GATE, f"{m}: interior EPE {epe}")
            ms = []
            for _ in range(N_FLOW_EXTRA_TIMED):
                _, t = self.wall_s(lambda: entry.dense_flow(I0, I1, m))
                ms.append(t * 1e3)
            res[m] = {"epe_interior": epe, "epe_all": float(dis.epe(f, gt_c)), "launches": split[m],
                      "ms_per_pair_median": float(np.median(ms)), "ms_per_pair": ms}
            if m in plain:
                d = float((f - plain[m]).abs().max())
                check(d <= FLOW_PLAIN_TOL, f"{m}: plain path differs by {d} px")
                res[m]["plain_path_max_abs_diff"] = d
        # GPC: a forest drawn from a seeded generator, trained on 4,096 descriptors of I0
        Ic0, Ic1 = self.card(I0), self.card(I1)
        t0 = time.perf_counter()
        forest = gpc.make_forest(torch.Generator().manual_seed(0), device=self.dev)
        d0 = gpc.patch_descriptors(Ic0).reshape(-1, gpc.DESC_DIM)
        sel = torch.from_numpy(np.random.default_rng(0).choice(d0.shape[0], 4096, replace=False)).to(self.dev)
        forest = gpc.train_forest(forest, d0[sel])
        p0, p1 = gpc.find_correspondences(Ic0, Ic1, forest)
        gpc_s = time.perf_counter() - t0
        true = gt[p0[:, 0].astype(int), p0[:, 1].astype(int)]
        good = float((np.abs(p1 - p0 - true).max(axis=1) <= 1.0).mean()) if len(p0) else 0.0
        # motion templates: a bar moving right 8 px a step at the pair's size
        H, W = I0.shape
        mhi = torch.zeros(H, W, device=self.dev)
        t0 = time.perf_counter()
        for t in range(1, 6):
            sil = torch.zeros(H, W, device=self.dev)
            sil[:, 8 * t:8 * t + 16] = 1.0
            mhi = motempl.update_motion_history(mhi, sil, float(t), 10.0)
        orient, valid = motempl.calc_motion_gradient(mhi, 0.5, 10.0)
        ang = float(motempl.calc_global_orientation(orient, valid, mhi, 5.0, 10.0))
        motempl_ms = (time.perf_counter() - t0) * 1e3
        check(min(ang, 360.0 - ang) < 45.0, f"motion templates: global orientation {ang} deg for a bar moving right")
        return {"frames": [2, H, W], "s_main_path": s, "launches": self.launches["dense_flow_extra"], **res,
                "gpc": {"matches": int(len(p0)), "within_1px_of_true_flow": good, "s": gpc_s},
                "motempl": {"global_orientation_deg": ang, "valid_pixels": int(valid.sum()), "ms": motempl_ms}}

    def remainder_card_vs_cpu(self) -> dict:
        """Each part of this phase at its CPU tests' size, on the card and on
        the CPU."""
        import tempfile

        from opencv_contrib_tpu_torch.flow import gpc, motempl
        from opencv_contrib_tpu_torch.rgbd import dynafu
        from opencv_contrib_tpu_torch.utils.tum_export import write_tum_sequence

        torch, entry = self.torch, self.entry
        cpu, tol, out = torch.device("cpu"), REMAINDER_CPU_TOL, {}
        mini = TUM_MINI
        poses, depths = self.orbit_depths(mini["shape"], mini["intr"], mini["n"], mini["sweep"])
        with tempfile.TemporaryDirectory(prefix="tum_mini_") as root:
            write_tum_sequence(root, depths.cpu().numpy(), poses)
            rc, rh = (entry.tum_kinfu(root, intr=mini["intr"], device=d, n_threads=2, prefetch=4, **mini["kinfu"])
                      for d in (self.dev, cpu))
        out["tum_pose"] = float(np.abs(rc.poses - rh.poses).max())
        out["tum_ate"] = [rc.ate, rh.ate]
        check(rc.lost == rh.lost == [] and out["tum_pose"] <= tol["tum_pose"]
              and abs(rc.ate - rh.ate) <= tol["tum_ate"], f"TUM mini path card vs CPU {out}")

        small = self.bump_depths((60, 80), 1, DYNAFU_SMALL_FRAMES)
        intr = [70.0, 70.0, 40.0, 30.0]
        trackers = []
        for d in (self.dev, cpu):
            df = dynafu.DynaFu(intr, frame_shape=(60, 80), device=d, **DYNAFU_SMALL)
            trackers.append((df, [df.update(x) for x in small.to(d)]))
        (dc, okc), (dh, okh) = trackers
        wc, vc = dc.render_live()
        wh, vh = dh.render_live()
        both = vc.cpu() & vh
        out["dynafu"] = {"ok": [okc, okh], "xi": float((dc.warp.xi.cpu() - dh.warp.xi).abs().max()),
                         "render_m": float((wc.cpu() - wh)[both].abs().max()),
                         "valid_differs": int((vc.cpu() != vh).sum())}
        check(okc == okh and out["dynafu"]["xi"] <= tol["dynafu_xi"] and out["dynafu"]["render_m"] <= tol["dynafu_render"]
              and out["dynafu"]["valid_differs"] <= 2, f"DynaFu card vs CPU {out['dynafu']}")

        Is0, Is1, _ = entry.flow_pair(*FLOW_EXTRA_SMALL)
        out["flow"] = {}
        for m in FLOW_EXTRA:
            fc = entry.dense_flow(Is0, Is1, m).cpu()
            fh = entry.dense_flow(Is0, Is1, m, device="cpu")
            diff = (fc - fh).abs().amax(-1)
            out["flow"][m] = {"max_abs": float(diff.max()), "over_tol_share": float((diff > tol["flow"]).float().mean())}
            check(out["flow"][m]["over_tol_share"] <= tol["flow_share"],
                  f"{m}: {FLOW_EXTRA_SMALL} pair, card vs CPU {out['flow'][m]}")
        forest = gpc.make_forest(torch.Generator().manual_seed(0))
        forest = gpc.train_forest(forest, gpc.patch_descriptors(torch.from_numpy(Is0)).reshape(-1, gpc.DESC_DIM)[::3])
        cc = gpc.leaf_codes(self.card(Is0), forest.to(self.dev)).cpu()
        ch = gpc.leaf_codes(torch.from_numpy(Is0), forest)
        out["gpc_codes_differ_share"] = float((cc != ch).float().mean())
        check(out["gpc_codes_differ_share"] <= tol["gpc_tie_share"], f"GPC codes card vs CPU {out}")
        mh = []
        for d in (self.dev, cpu):
            mhi = torch.zeros(16, 16, device=d)
            for t in range(1, 6):
                sil = torch.zeros(16, 16, device=d)
                sil[:, 2 * t:2 * t + 2] = 1.0
                mhi = motempl.update_motion_history(mhi, sil, float(t), 10.0)
            o, v = motempl.calc_motion_gradient(mhi, 0.5, 10.0)
            mh.append((o.cpu(), v.cpu(), float(motempl.calc_global_orientation(o, v, mhi, 5.0, 10.0))))
        (oc, vc_, gc), (oh, vh_, gh) = mh
        out["motempl"] = {"orient_deg": float((oc - oh).abs().max()), "valid_equal": bool(torch.equal(vc_, vh_)),
                          "global_deg": abs(gc - gh)}
        check(out["motempl"]["valid_equal"] and out["motempl"]["global_deg"] <= tol["motempl_deg"],
              f"motion templates card vs CPU {out['motempl']}")
        return out

    # ---- (r) -----------------------------------------------------------------
    def distributed(self):
        """The distributed layer on a world-size-1 NCCL mesh in this process:
        each path once with the counters read around it, once under the
        profiler and the sync log, and against its single-device twin."""
        from opencv_contrib_tpu_torch.parallel import mesh as pm

        torch = self.torch
        mesh = pm.make_mesh(1, 1, device="cuda")
        warm = pm.psum(torch.ones(1, device=self.dev), mesh, pm.AXES)  # the communicator's set-up, outside the timings
        check(float(warm) == 1.0, "NCCL all_reduce of one rank")
        out, parts = {"mesh": list(mesh.shape), "backend": self.torch.distributed.get_backend()}, {}
        for name, fn in (("dense_ba", self.dist_dense), ("sparse_ba", self.dist_sparse),
                         ("global_ba", self.dist_global), ("dist_sfm", self.dist_sfm),
                         ("submap_shard", self.dist_submaps), ("stage_pipeline", self.dist_stages),
                         ("checkpoint", self.dist_checkpoint), ("dryrun_multichip", self.dist_dryrun)):
            t0 = time.perf_counter()
            out[name] = fn(mesh)
            parts[name] = time.perf_counter() - t0
        emit({"phase": "r_distributed", **out, "phase_parts_s": parts,
              "tolerance": f"each path against its single-device twin on the card, max |a - b| / max |b| <= "
                           f"{DIST_REL_TOL} (stage pipeline, checkpoint: equal bits); the dryrun's gates",
              "timing": "wall_s: host clock around the counted run, wall_s_turns / twin_wall_s_turns: the path and its "
                        "twin in turns after it (twin, path, twin); device_ms and nccl from the raw kineto events of "
                        "a profiled run (device events only; ncclDevKernel_* kernels), with the sync log on",
              "ok": True})

    def dist_run(self, path: str, fn, twin=None) -> tuple:
        """fn() once counted (wall s, launches of the port's kernels), then
        once under torch.profiler and the sync log (device ms and launches,
        NCCL launches and device ms, host syncs, the top device ops). With
        its single-device twin: the twin first (a warm-up of the shared
        code), and after the profile the twin, fn and the twin again on the
        host's clock, so the two walls are read in turns. Returns (fn's
        result, the twin's, the row)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        if twin is not None:
            twin()
        res, wall = self.counted(path, fn)
        if self.marker is None:
            self.marker = torch.empty(16, dtype=torch.uint8, device=self.dev)
        pad = WINDOW_PAD_S
        for _ in range(DIST_WINDOWS):  # a window that kept no marker may have lost fn's first events: again
            torch.cuda.synchronize()
            with self.sync_log() as got:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only: a long path's
                    time.sleep(pad)                                          # CPU ops would triple the events
                    for _ in range(DIST_MARKERS):
                        self.marker.zero_()
                    fn()
                    torch.cuda.synchronize()
            by_name, markers = {}, 0
            for e in prof.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CUDA:
                    continue
                if FLUSH_KERNEL in e.name():
                    markers += 1
                    continue
                agg = by_name.setdefault(e.name(), [0, 0])
                agg[0] += 1
                agg[1] += e.duration_ns()
            if markers:
                break
            pad *= 4
        check(markers > 0, f"{path}: no profiler window kept its markers")
        nccl = [v for n, v in by_name.items() if n.startswith(DIST_PREFIX)]
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
        row = {"wall_s": wall, "device_ms": sum(v[1] for v in by_name.values()) / 1e6,
               "device_launches": sum(v[0] for v in by_name.values()),
               "nccl_launches": sum(v[0] for v in nccl), "nccl_device_ms": sum(v[1] for v in nccl) / 1e6,
               "host_syncs": self.sync_summary(got)["in_the_port"],
               "port_kernel_launches": {k: v for k, v in self.launches[path].items() if v},
               "top_device": [{"name": n[:60], "count": c, "ms": d / 1e6} for n, (c, d) in top]}
        twin_res = None
        if twin is not None:
            twin_res, t1 = self.wall_s(twin)
            _, m2 = self.wall_s(fn)
            _, t2 = self.wall_s(twin)
            row.update(wall_s_turns=[wall, m2], twin_wall_s_turns=[t1, t2],
                       twin_host_syncs=self.count_syncs(twin)["in_the_port"])
        return res, twin_res, row

    @staticmethod
    def rel_diff(a, b) -> float:
        a, b = (np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64) for x in (a, b))
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def held(self, what: str, pairs) -> float:
        """The largest relative difference over (mesh, twin) pairs, gated."""
        worst = max(self.rel_diff(a, b) for a, b in pairs)
        check(worst <= DIST_REL_TOL, f"{what}: the mesh path against its single-device twin: {worst}")
        return worst

    def dist_dense(self, mesh) -> dict:
        """bench.py::bench_keyframes's BA refresh, 16 x 2048, 10 LM."""
        from opencv_contrib_tpu_torch.ba import bundle
        from opencv_contrib_tpu_torch.parallel import dist_ba

        prob = self.entry.ba_problem(16, 2048, device=self.dev)
        res, ref, row = self.dist_run("dist_dense_ba", lambda: dist_ba.bundle_adjust(prob, mesh, n_iters=N_BA),
                                      lambda: bundle.bundle_adjust(prob, n_iters=N_BA))
        row["max_rel_diff"] = self.held("dense dist_ba", zip(res, ref))
        row.update(views=16, points=2048, lm_iters=N_BA, cost=[float(res.initial_cost), float(res.final_cost)])
        return row

    def dist_sparse(self, mesh) -> dict:
        """Phase n's 2048 x 200,000 x 2,000,000 problem, 3 LM x 10 CG."""
        from opencv_contrib_tpu_torch.ba import sparse
        from opencv_contrib_tpu_torch.parallel import dist_ba

        prob, buckets = two_million_problem(self.dev)
        kw = dict(n_iters=SPARSE_BIG_ITERS, n_cg=SPARSE_BIG_CG, buckets=buckets)
        res, ref, row = self.dist_run("dist_sparse_ba", lambda: dist_ba.bundle_adjust_sparse(prob, mesh, **kw),
                                      lambda: sparse.bundle_adjust_sparse(prob, **kw))
        row["max_rel_diff"] = self.held("sparse dist_ba", zip(res, ref))
        row.update(problem=list(SPARSE_BIG), lm_iters=SPARSE_BIG_ITERS, cg_iters=SPARSE_BIG_CG,
                   cost=[float(res.initial_cost), float(res.final_cost)])
        del prob, buckets, res, ref
        self.torch.cuda.empty_cache()
        return row

    def dist_global(self, mesh) -> dict:
        """global_ba (15 LM x 15 CG) on copies of phase o's reconstruction,
        its points and translations moved by N(0, 0.01) from a seed so the
        bundle has work to do, on the mesh and without it."""
        import copy

        from opencv_contrib_tpu_torch.sfm import pipeline_scale

        tracks, rec = self.scale_rec
        rec = copy.deepcopy(rec)
        rng = np.random.default_rng(7)
        rec.points = (rec.points + rng.normal(scale=0.01, size=rec.points.shape)).astype(np.float32)
        rec.ts = (rec.ts + rng.normal(scale=0.01, size=rec.ts.shape)).astype(np.float32)

        def bundled(mesh_=None):
            r = copy.deepcopy(rec)
            pipeline_scale.global_ba(r, tracks, mesh=mesh_)
            return r

        on_mesh, twin, row = self.dist_run("dist_global_ba", lambda: bundled(mesh), bundled)
        check(np.abs(twin.ts - rec.ts).max() > 0, "global_ba moved no pose")
        row["max_rel_diff"] = self.held("global_ba(mesh=)", [(getattr(on_mesh, f), getattr(twin, f))
                                                              for f in ("Rs", "ts", "points")])
        row.update(views=tracks.n_views, slots=tracks.slots, registered=int(rec.registered.sum()),
                   mean_px_perturbed_then_bundled=[rec.reprojection_mean_px(tracks),
                                                   on_mesh.reprojection_mean_px(tracks)])
        return row

    def dist_sfm(self, mesh) -> dict:
        """batched_frontend -> distributed_matching -> distributed_bundle on
        the first 32 of entry.make_frames(32)'s frames at K=512; the twin
        detects and describes frame by frame (in full f32, as
        batched_frontend runs), matches by all_pairs_match_reference and
        bundles by ba.bundle."""
        from opencv_contrib_tpu_torch.ba import bundle
        from opencv_contrib_tpu_torch.features import describe, detect
        from opencv_contrib_tpu_torch.parallel import dist_sfm, ring_match
        from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

        torch = self.torch
        imgs = self.frames[:DIST_SFM_FRAMES]
        prob = self.entry.ba_problem(16, 2048, device=self.dev)

        def step():
            descs, xy, valid = dist_sfm.batched_frontend(imgs, mesh, max_keypoints=K, threshold=FRONTEND["threshold"])
            match = dist_sfm.distributed_matching(descs, valid, mesh)
            return (descs, xy, valid), match, dist_sfm.distributed_bundle(prob, mesh, n_iters=N_BA)

        def twin():
            out = []
            with f32_matmul_precision():
                for img in imgs:
                    img = self.card(img)
                    k = detect.fast_hessian(img, max_keypoints=K, threshold=FRONTEND["threshold"], n_octaves=2)
                    out.append((describe.surf_describe(img, k), k.xy(), k.valid))
            fe = [torch.stack([t[i] for t in out]) for i in range(3)]
            return fe, ring_match.all_pairs_match_reference(fe[0], fe[2]), bundle.bundle_adjust(prob, n_iters=N_BA)

        (fe, match, ba), (t_fe, t_match, t_ba), row = self.dist_run("dist_sfm_step", step, twin)
        check(all(torch.equal(a, b) for a, b in zip(fe[1:], t_fe[1:])) and torch.equal(match[2], t_match[2])
              and torch.equal(match[0][match[2]], t_match[0][match[2]]), "dist_sfm: keypoints or matches differ")
        row["max_rel_diff"] = self.held("dist_sfm", [(fe[0], t_fe[0]), (match[1][match[2]], t_match[1][match[2]]),
                                                     *zip(ba, t_ba)])
        n = DIST_SFM_FRAMES
        row.update(frames=[n, 480, 640], K=K, distance_block_gb=n * n * K * K * 4 / 1e9,
                   valid_keypoints=int(fe[2].sum()), matches_0_1=int(match[2][0, 1].sum()),
                   matches_total=int(match[2].sum()))
        check(row["matches_0_1"] > 10, f"dist_sfm: frames 0 and 1 match {row['matches_0_1']} keypoints")
        del fe, match, t_fe, t_match
        torch.cuda.empty_cache()
        return row

    def dist_submaps(self, mesh) -> dict:
        """16 submaps x 4,096 boundary points in a ring, 25 sharded GN steps
        (tests/test_parallel.py's count); the twin is the same steps with
        the all_reduce taken out."""
        from opencv_contrib_tpu_torch.core import se3
        from opencv_contrib_tpu_torch.parallel import submap_shard

        torch = self.torch
        S, M = DIST_SUBMAPS
        rng = np.random.default_rng(0)
        xi = np.concatenate([np.zeros((1, 6)), 0.2 * rng.standard_normal((S - 1, 6))]).astype(np.float32)
        T_true = se3.exp_se3(self.card(xi))
        pts = self.card(rng.uniform(-1, 1, (S, M, 3)))
        nbr = torch.arange(S, device=self.dev).roll(1)  # submap s borders s - 1
        pw = torch.einsum("smk,sjk->smj", pts, T_true[:, :3, :3]) + T_true[:, None, :3, 3]
        Tn = torch.linalg.inv(T_true[nbr])
        tgt = torch.einsum("smk,sjk->smj", pw, Tn[:, :3, :3]) + Tn[:, None, :3, 3]
        w = torch.ones((S, M), device=self.dev)
        noise = np.concatenate([np.zeros((1, 6)), 0.05 * rng.standard_normal((S - 1, 6))]).astype(np.float32)
        T0 = se3.exp_se3(self.card(noise)) @ T_true
        args = (T0, pts, tgt, nbr, w)

        def twin():
            with mock.patch.object(submap_shard, "psum", lambda x, mesh, axes: x):
                return submap_shard.optimize_submaps(*args, mesh, n_iters=DIST_SUBMAP_ITERS)

        out, ref, row = self.dist_run(
            "dist_submaps", lambda: submap_shard.optimize_submaps(*args, mesh, n_iters=DIST_SUBMAP_ITERS), twin)
        row["max_rel_diff"] = self.held("submap_shard", [(out, ref)])
        err = [float((T - T_true)[1:].norm(dim=(1, 2)).mean()) for T in (T0, out)]
        check(err[1] < 0.3 * err[0], f"submap_shard: pose error {err[0]} -> {err[1]}")
        row.update(submaps=S, boundary_points=M, gn_steps=DIST_SUBMAP_ITERS, pose_error=err)
        return row

    def dist_stages(self, mesh) -> dict:
        """frontend_stages at 480x640, n_kp=512, over 8 frames: an extent-1
        pp axis takes the three stages composed into one; the twin is the
        sequential chain, held at atol 0."""
        from torch.distributed.device_mesh import DeviceMesh

        from opencv_contrib_tpu_torch.features import describe, detect
        from opencv_contrib_tpu_torch.parallel import stage_pipeline

        torch = self.torch
        ref = self.card(self.frames[0])
        kp = detect.fast_hessian(ref, max_keypoints=K, threshold=FRONTEND["threshold"])
        stages, pack, unpack, C = stage_pipeline.frontend_stages(describe.surf_describe(ref, kp), kp.valid,
                                                                 img_hw=(480, 640), n_kp=K,
                                                                 threshold=FRONTEND["threshold"])
        pp = DeviceMesh(mesh.device_type, [0], mesh_dim_names=("pp",))
        items = torch.stack([pack(self.card(f)) for f in self.frames[:DIST_STAGE_FRAMES]])

        def chain(x):
            for st in stages:
                x = st(x)
            return x

        out, seq, row = self.dist_run("dist_stage_pipeline",
                                      lambda: stage_pipeline.pipeline_map_sharded([chain], items, pp),
                                      lambda: torch.stack([chain(x) for x in items]))
        check(torch.equal(out, seq), "stage pipeline: the pipelined chain differs from the sequential one")
        idx0, dist0 = unpack(out[0])
        row.update(frames=[DIST_STAGE_FRAMES, 480, 640], n_kp=K, carrier_floats=C, equal_bits=True,
                   self_matches_frame0=int((dist0 > -0.5).sum()))
        check(row["self_matches_frame0"] >= K // 4, f"stage pipeline: frame 0 matched {row['self_matches_frame0']}")
        return row

    def dist_checkpoint(self, mesh) -> dict:
        """save_slam_state of a 256^3 KinFu volume after 3 orbit frames, its
        pose and a 3-node pose graph; restored bit for bit."""
        import tempfile

        from opencv_contrib_tpu_torch.core import se3
        from opencv_contrib_tpu_torch.parallel import checkpoint
        from opencv_contrib_tpu_torch.rgbd import posegraph

        torch = self.torch
        _, depths = self.orbit_depths(n=3)
        tr = self.entry.kinfu_track(depths, KINFU_INTR, volume_resolution=DIST_VOLUME,
                                    volume_size=KINFU_ORBIT["volume_size"], volume_center=KINFU_ORBIT["volume_center"],
                                    device=self.dev)
        poses = se3.inverse(tr.T_cw)
        graph = posegraph.make_graph(poses, [[0, 1], [1, 2]], se3.inverse(poses[:-1]) @ poses[1:], device=self.dev)
        state = {"volume": tr.volume, "T_cw": tr.T_cw[-1], "posegraph": graph}
        with tempfile.TemporaryDirectory(prefix="ckpt_") as d:
            def round_trip():
                path = checkpoint.save_slam_state(os.path.join(d, "slam"), **state)
                return path, checkpoint.restore_pytree(path, state)

            (path, back), _, row = self.dist_run("dist_checkpoint", round_trip)
            mb = os.path.getsize(path) / 2 ** 20
            t0 = time.perf_counter()
            checkpoint.restore_pytree(path, state)
            s_restore = time.perf_counter() - t0
        same = [torch.equal(a, b) for a, b in zip(*(torch.utils._pytree.tree_leaves(x) for x in (state, back)))]
        check(all(same) and len(same) == 5 + 1 + 6, f"checkpoint: {sum(same)} of {len(same)} leaves equal")
        row.update(volume=list(DIST_VOLUME), leaves=len(same), equal_bits=True, file_mb=mb, s_restore=s_restore)
        return row

    def dist_dryrun(self, mesh) -> dict:
        out, _, row = self.dist_run("dryrun_multichip", lambda: self.entry.dryrun_multichip(1))
        row.update(out)
        return row

    # ---- (s) -----------------------------------------------------------------
    def xfeatures(self):
        out, parts = {}, {}
        self.xfeat_calls = {}  # path -> its call, for one profiler window over them all
        for name, fn in (("kernels", self.xfeat_kernels), ("paths", self.xfeat_paths), ("gates", self.xfeat_gates),
                         ("device", self.xfeat_device), ("plain_path", self.xfeat_plain),
                         ("card_vs_cpu", self.xfeat_card_vs_cpu)):
            t0 = time.perf_counter()
            out[name] = fn()
            parts[name] = time.perf_counter() - t0
        emit({"phase": "s_xfeatures2d", **out, "phase_parts_s": parts,
              "tolerance": f"knn2: rtol 1e-5, atol 1e-4, idx agreement >= 0.999; integral tables: max abs err <= "
                           f"2e-6 * max|table|, equal bits on a rerun; box-blur stacks: 2 x 3 passes x 4 entries x "
                           f"the float32 spacing of the largest table / the smallest box area; gates: "
                           f"tests/test_features_x.py's {XFEAT_GATES} and the JAX tests' detector, GMS, LOGOS, "
                           f"PCT, template and LINEMOD gates; plain path: {XFEAT_PLAIN_TOL}; card vs CPU: "
                           f"{XFEAT_CPU_TOL}",
              "timing": "ms: device time a call, from one profiler window of XFEAT_REPS calls a kernel (raw kineto "
                        "events, kernels joined to record_function spans); wall_ms: CUDA events a call; a path's s: "
                        "host clock around one synchronised call; device: each path's kernel time and launches, "
                        "from one profiler window over all paths",
              "ok": True})

    def xfeat_profile(self, calls: dict, reps: int = 1) -> dict:
        """Device ms and launches of each call in `calls` (span name -> fn,
        run `reps` times), all in one profiler window read from the raw
        kineto events (`kineto_rows`): a window in this late a process drops
        its first events, so it opens with DIST_MARKERS fills and is taken
        again, up to DIST_WINDOWS times, when a span kept none of its
        kernels. Returns the spans' rows, device ms and launches a call."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        if self.marker is None:
            self.marker = torch.empty(16, dtype=torch.uint8, device=self.dev)
        for fn in calls.values():
            fn()
        lost = []
        for _ in range(DIST_WINDOWS):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(WINDOW_PAD_S)
                for _ in range(DIST_MARKERS):
                    self.marker.zero_()
                t0 = time.perf_counter()
                for name, fn in calls.items():
                    with torch.profiler.record_function(XFEAT_PREFIX + name):
                        for _ in range(reps):
                            fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                time.sleep(WINDOW_PAD_S)
            rows = self.kineto_rows(prof, wall, XFEAT_PREFIX, set(calls), require=False, by_kernel=True)["spans"]
            lost = [n for n in calls if rows[n]["launches"] == 0]
            if not lost:
                return {n: {"device_ms": rows[n]["device_ms"] / reps, "launches": rows[n]["launches"] / reps,
                            "kernels": rows[n]["kernels"]} for n in calls}
        raise AssertionError(f"torch.profiler kept no kernel of {lost} in {DIST_WINDOWS} windows")

    def xfeat_kernels(self) -> dict:
        """knn2 at the descriptor widths of the new paths and the integral
        kernel at their tables, each against its plain version; all timed in
        one profiler window."""
        import torch.nn.functional as F

        from opencv_contrib_tpu_torch.ops import filters, integral
        from opencv_contrib_tpu_torch.ops.cuda import matching as fused
        from opencv_contrib_tpu_torch.ops.cuda import scan
        from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

        torch = self.torch
        widths, calls = {}, {}
        Q = XFEAT_K
        for D in XFEAT_KNN2_WIDTHS:
            q, t = self.card(self.gen.normal(size=(Q, D))), self.card(self.gen.normal(size=(Q, D)))
            with f32_matmul_precision():
                d, i = fused.knn2(q, t)
                dp, ip = fused.knn2_plain(q, t)
                again = fused.knn2(q, t)
                torch.cuda.synchronize()
            err = float((d - dp).abs().max())
            worst = float(((d - dp).abs() / (1e-4 + 1e-5 * dp.abs())).max())
            agree = float((i == ip).float().mean())
            check(worst <= 1.0 and agree >= 0.999, f"knn2 {Q}x{Q}x{D}: err/tol {worst}, idx agreement {agree}")
            check(torch.equal(again[0], d) and torch.equal(again[1], i), f"knn2 {Q}x{Q}x{D}: a rerun differs")
            calls.update({f"knn2_{D}": lambda q=q, t=t: fused.knn2(q, t),
                          f"knn2_plain_{D}": lambda q=q, t=t: fused.knn2_plain(q, t),
                          f"knn2_library_{D}": lambda q=q, t=t: torch.topk(torch.cdist(q, t), 2, dim=1, largest=False)})
            nbytes, ops = 4 * (2 * Q * D + 3 * Q), 2 * Q * Q * D
            widths[str(D)] = {"shape": [Q, Q, D], "max_abs_err": err, "err_over_tol": worst, "idx_agree": agree,
                              "bound_ms": max(nbytes / self.bw, ops / self.flops) * 1e3,
                              "bound_by": "operations" if ops / self.flops > nbytes / self.bw else "bytes"}

        tables = {}
        frame = self.card(np.round(self.gen.uniform(0, 255, size=XFEAT_SHAPE)))
        for r in XFEAT_PAD_RADII:
            p = F.pad(frame[None, None], (r,) * 4, mode="replicate")[0, 0]
            ii, ref = integral.integral(p), scan.integral_padded_plain(p)
            torch.cuda.synchronize()
            err, top = float((ii - ref).abs().max()), float(ref.abs().max())
            check(err <= 2e-6 * top and torch.equal(integral.integral(p), ii),
                  f"integral of the {r}-padded VGA frame: max err {err} (max {top}), a rerun equal")
            calls[f"integral_r{r}"] = lambda p=p: integral.integral(p)
            if r == XFEAT_PAD_RADII[1]:  # FREAK's widest pad, beside its plain version and two cumsums
                calls[f"integral_plain_r{r}"] = lambda p=p: scan.integral_padded_plain(p)
                calls[f"integral_library_r{r}"] = lambda p=p: F.pad(torch.cumsum(torch.cumsum(p, 0), 1), (1, 0, 1, 0))
            H, W = p.shape
            tables[str(r)] = {"table": f"VGA edge-padded by {r}", "shape": [H, W], "max_abs_err": err,
                              "max_abs": top, "bound_ms": 4 * (H * W + (H + 1) * (W + 1)) / self.bw * 1e3,
                              "bound_by": "bytes"}

        stacks = {}
        for shape, sigma in ((XFEAT_CUBE, 4.0), ((8,) + XFEAT_SHAPE, 4.2)):
            x = self.card(self.gen.uniform(0, 1, size=shape))
            self.kern.reset_launches()
            out = filters.fast_gaussian_blur(x, sigma)
            n = self.kern.launches()["integral_image"]
            with plain_path():
                ref = filters.fast_gaussian_blur(x, sigma)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            biggest = float(x.sum(dim=(-2, -1)).max())  # about the largest table entry
            wl = int(np.floor(np.sqrt(4.0 * sigma * sigma + 1.0)))
            n_min = wl - 1 if wl % 2 == 0 else wl
            tol = 2 * 3 * 4 * float(np.spacing(np.float32(biggest * 1.1))) / n_min ** 2
            check(n == 3 * shape[0] and err <= tol, f"fast_gaussian_blur {shape} sigma {sigma}: {n} integral "
                                                    f"launches, max err {err} > {tol}")
            key = "x".join(map(str, shape))

            def plain(x=x, sigma=sigma):
                with plain_path():
                    return filters.fast_gaussian_blur(x, sigma)

            calls[f"blur_{key}"] = lambda x=x, sigma=sigma: filters.fast_gaussian_blur(x, sigma)
            calls[f"blur_plain_{key}"] = plain
            stacks[key] = {"shape": list(shape), "sigma": sigma, "integral_launches": n, "max_abs_err": err,
                           "tol": tol}

        prof = self.xfeat_profile(calls, reps=XFEAT_REPS)
        for D, row in widths.items():
            k = prof[f"knn2_{D}"]
            check(k["launches"] == 1 and all(is_ours(name, "knn2_kernel") for name in k["kernels"]),
                  f"knn2 {D}: device launches a call {k}")
            row.update(ms=k["device_ms"], launches_per_call=k["launches"],
                       plain_ms=prof[f"knn2_plain_{D}"]["device_ms"],
                       library_ms=prof[f"knn2_library_{D}"]["device_ms"],
                       wall_ms=self.wall_ms(calls[f"knn2_{D}"]))
        for r, row in tables.items():
            k = prof[f"integral_r{r}"]
            check(k["launches"] == 1 and all(is_ours(name, "integral_kernel") for name in k["kernels"]),
                  f"integral r={r}: device launches a call {k}")
            row.update(ms=k["device_ms"], launches_per_call=k["launches"])
            if f"integral_plain_r{r}" in prof:
                row.update(plain_ms=prof[f"integral_plain_r{r}"]["device_ms"],
                           library_ms=prof[f"integral_library_r{r}"]["device_ms"],
                           wall_ms=self.wall_ms(calls[f"integral_r{r}"]))
        for key, row in stacks.items():
            row.update(ms=prof[f"blur_{key}"]["device_ms"], launches_per_call=prof[f"blur_{key}"]["launches"],
                       plain_ms=prof[f"blur_plain_{key}"]["device_ms"])
        self.kernels["knn2"]["widths"] = {D: {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                                                 "bound_by", "max_abs_err")}
                                          for D, r in widths.items()}
        return {"knn2_widths": widths, "integral_tables": tables, "box_blur_stacks": stacks}

    @staticmethod
    def inlier_rate(r, fwd, tol: float = 3.0):
        """(inlier share, matches) of a features_x result under the known map."""
        v = r.matches.valid.cpu().numpy()
        if v.sum() == 0:
            return 0.0, 0
        p1 = np.stack([r.k1.x.cpu().numpy(), r.k1.y.cpu().numpy()], 1)
        mapped = p1 @ fwd[:, :2].T + fwd[:, 2]
        t = r.matches.train_idx.cpu().numpy().astype(np.int64)
        err = np.hypot(mapped[:, 0] - r.k2.x.cpu().numpy()[t], mapped[:, 1] - r.k2.y.cpu().numpy()[t])
        return float((err[v] < tol).mean()), int(v.sum())

    def xfeat_path(self, path: str, fn):
        """One path: a warm-up call, the counted call and its host syncs; its
        device time waits for the phase's one profiler window
        (`xfeat_device`)."""
        fn()
        out, s = self.counted(path, fn)
        syncs = self.count_syncs(fn)
        self.xfeat_calls[path] = fn
        return out, {"s": s, "launches": {k: self.launches[path][k] for k in PATH_KERNELS[path]},
                     "host_syncs": syncs["total"], "host_syncs_in_port": syncs["in_the_port"],
                     "sync_sites": syncs["top_sites"]}

    def xfeat_device(self) -> dict:
        """Every path's device ms and launches, and its five costliest
        kernels (launches, ms), from one profiler window."""
        prof = self.xfeat_profile(self.xfeat_calls)
        out = {}
        for path, row in prof.items():
            top = sorted(row["kernels"].items(), key=lambda kv: -kv[1][1])[:5]
            out[path] = {"device_ms": row["device_ms"], "device_launches": row["launches"],
                         "costliest": {k[:80]: [n, ms] for k, (n, ms) in top}}
        return out

    def xfeat_jobs(self):
        return ([(f"xfeat_{d}", d, "surf") for d in XFEAT_DETECTORS]
                + [(f"xfeat_{d}", "fast_hessian", d) for d in XFEAT_DESCRIPTORS])

    def xfeat_paths(self) -> dict:
        """entry.features_x on the VGA pair with every detector and every
        descriptor, the rotation gates, and the descriptors' own JAX-test
        gates."""
        from opencv_contrib_tpu_torch.features import describe

        torch, entry = self.torch, self.entry
        img1, img2, fwd = entry.feature_pair(*XFEAT_SHAPE)
        self.xfeat_pair = (img1, img2, fwd)
        a, b = self.card(img1), self.card(img2)
        runs, results = {}, {}
        for path, det, desc in self.xfeat_jobs():
            r, row = self.xfeat_path(path, lambda det=det, desc=desc: entry.features_x(a, b, det, desc, K=XFEAT_K,
                                                                                       device=self.dev))
            rate, n = self.inlier_rate(r, fwd)
            row.update(detector=det, descriptor=desc, kp=[int(r.k1.count()), int(r.k2.count())], matches=n,
                       inlier_share=rate, width=int(r.d1.shape[1]))
            check(min(row["kp"]) > 0 and n > 0, f"{path}: keypoints {row['kp']}, matches {n}")
            if desc in XFEAT_GATES:
                gn, grate = XFEAT_GATES[desc]
                check(n > gn and rate > grate, f"{path}: {n} matches at inlier share {rate} (gate {gn}, {grate})")
            runs[path], results[path] = row, r
        # the JAX tests' own gates on the descriptors without a rotation gate
        r = results["xfeat_daisy"]
        norms = torch.linalg.norm(r.d1.reshape(XFEAT_K, 25, 8), dim=-1)
        check(float(norms.max()) < 1.0 + 1e-4, f"DAISY: a histogram of norm {float(norms.max())}")
        r = results["xfeat_lucid"]
        rows = torch.sort(r.d1[r.k1.valid], dim=1).values
        check(bool(torch.allclose(rows, torch.arange(49, device=self.dev) / 48.0, atol=1e-6)),
              "LUCID: a valid row is not a permutation of the ranks")
        r = results["xfeat_boxes"]
        packed, signs = describe.binary_boxes_describe(a, r.k1)
        check(torch.equal(describe.unpack_to_signs(packed, 256) * r.k1.valid[:, None], signs)
              and torch.equal(signs, r.d1), "boxes: packed words and signs differ")
        self.xfeat_results = results
        return {"frames": [2, *XFEAT_SHAPE], "K": XFEAT_K, "angle_deg": 15.0, "runs": runs}

    @staticmethod
    def blob_image(centers, sigmas, shape):
        H, W = shape
        y, x = np.mgrid[0:H, 0:W]
        img = np.zeros(shape, np.float32)
        for (cy, cx), sg in zip(centers, sigmas):
            img += 200.0 * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * sg * sg))
        return img

    def xfeat_gates(self) -> dict:
        """The JAX tests' detector gates on VGA frames, GMS and LOGOS, TBMR
        with affine adaptation, PCT, template matching, LINEMOD and CCL, each
        a counted path."""
        from opencv_contrib_tpu_torch.features import detect, detect_x, match, pct
        from opencv_contrib_tpu_torch.features import keypoints as kp_mod
        from opencv_contrib_tpu_torch.ops import ccl, template_match
        from opencv_contrib_tpu_torch.rgbd import linemod

        torch = self.torch
        H, W = XFEAT_SHAPE
        out = {}
        centers = [(150, 200), (150, 440), (330, 200), (330, 440)]
        k = detect_x.star_detector(self.card(self.blob_image(centers, [5] * 4, XFEAT_SHAPE)), max_keypoints=16)
        got = np.stack([k.y.cpu().numpy(), k.x.cpu().numpy()], 1)[k.valid.cpu().numpy()]
        dist = [float(np.hypot(got[:, 0] - cy, got[:, 1] - cx).min()) for cy, cx in centers]
        check(max(dist) < 3.0, f"Star: blob distances {dist}")
        sq = np.zeros(XFEAT_SHAPE, np.float32)
        sq[232:248, 312:328] = 200.0
        k = detect_x.msd_detector(self.card(sq), max_keypoints=16)
        got = np.stack([k.y.cpu().numpy(), k.x.cpu().numpy()], 1)[k.valid.cpu().numpy()]
        edge = np.minimum(np.abs(got - [232, 312]), np.abs(got - [247, 327])).min(1)
        check(len(got) >= 4 and (edge < 8).all(), f"MSD: {len(got)} detections, edge distances {edge}")
        noise = np.random.default_rng(0).uniform(0, 2, XFEAT_SHAPE).astype(np.float32)
        scales = [float(detect_x.harris_laplace(self.card(self.blob_image([(240, 320)], [sg], XFEAT_SHAPE) + noise),
                                                max_keypoints=8).scale[0]) for sg in (3.0, 6.0)]
        check(scales[1] > scales[0], f"Harris-Laplace: scales {scales} for blobs of sigma 3 and 6")
        checker = np.random.default_rng(0).uniform(0, 50, XFEAT_SHAPE).astype(np.float32)
        for i in range(8):
            for j in range(10):
                if (i + j) % 2 == 0:
                    checker[20 + i * 55:75 + i * 55, 20 + j * 60:80 + j * 60] += 150.0
        kh = detect.harris(self.card(checker), max_keypoints=XFEAT_K)
        resp = kh.response[kh.valid].cpu().numpy()
        kf = detect.fast_corners(self.card(checker / 255.0), max_keypoints=XFEAT_K, threshold=0.1)
        check(int(kh.count()) >= 9 and (np.diff(resp) <= 1e-5 * max(1.0, abs(resp).max())).all()
              and int(kf.count()) >= 4, f"Harris {int(kh.count())} / FAST {int(kf.count())} on the checkerboard")
        out["detectors"] = {"star_blob_px": dist, "msd": int(len(got)), "harris_laplace_scales": scales,
                            "harris": int(kh.count()), "fast": int(kf.count())}

        blobs = self.card(np.round(self.blob_image([(160, 200), (320, 440)], [6, 6], XFEAT_SHAPE)))
        yy, xx = np.mgrid[0:H, 0:W]
        ridge = self.card(200.0 * np.exp(-(((yy - 240) / 4.0) ** 2 + ((xx - 320) / 12.0) ** 2) / 2))
        kr = kp_mod.from_arrays(y=[240.0], x=[320.0], scale=[6.0], device=self.dev)

        def tbmr_path():
            return detect_x.tbmr(blobs, max_regions=16), detect_x.affine_adapt(ridge, kr)

        (ek, ea), row = self.xfeat_path("xfeat_tbmr", tbmr_path)
        v = ek.valid.cpu().numpy()
        c = np.stack([ek.y.cpu().numpy()[v], ek.x.cpu().numpy()[v]], 1)
        ratio = float(ea.a[0] / ea.b[0])
        check(v.sum() >= 2 and all(np.hypot(c[:, 0] - cy, c[:, 1] - cx).min() < 4.0 for cy, cx in [(160, 200),
                                                                                                  (320, 440)])
              and ratio > 1.5, f"TBMR: {int(v.sum())} regions at {c.tolist()}; affine a/b {ratio}")
        out["tbmr"] = {**row, "regions": int(v.sum()), "affine_ratio": ratio}

        rng = np.random.default_rng(0)
        n = 200
        xy1 = rng.uniform(50, 590, size=(n, 2)).astype(np.float32)
        xy2 = xy1 + np.array([20.0, 10.0], np.float32)
        xy2[:40] = rng.uniform(0, 640, size=(40, 2)).astype(np.float32)
        ones = match.Matches(torch.arange(n, dtype=torch.int32, device=self.dev),
                             torch.arange(n, dtype=torch.int32, device=self.dev), torch.zeros(n, device=self.dev),
                             torch.ones(n, dtype=torch.bool, device=self.dev))
        g = match.gms_filter(ones, self.card(xy1), self.card(xy2), shape1=(640, 640), shape2=(640, 640), grid=10,
                             tau_factor=3.0).valid.cpu().numpy()
        check(g[40:].mean() > 0.5 and g[:40].mean() < 0.25, f"GMS gate: kept {g[40:].mean()} / {g[:40].mean()}")
        r = self.entry.features_x(self.card(self.xfeat_pair[0]), self.card(self.xfeat_pair[1]), "fast_hessian",
                                  "surf", K=XFEAT_K, device=self.dev)
        fwd = self.xfeat_pair[2]

        def filters_path():
            xy1_, xy2_ = r.k1.xy(), r.k2.xy()
            return (match.gms_filter_auto(r.matches, xy1_, xy2_, shape1=XFEAT_SHAPE, shape2=XFEAT_SHAPE),
                    match.logos_filter(r.matches, xy1_, xy2_))

        (mg, ml), row = self.xfeat_path("xfeat_gms_logos", filters_path)
        share = {}
        for name, m in (("matches", r.matches), ("gms", mg), ("logos", ml)):
            share[name] = self.inlier_rate(r._replace(matches=m), fwd)
        check(share["logos"][0] >= share["matches"][0] and share["logos"][1] > 0,
              f"LOGOS on the VGA pair: {share}")
        out["gms_logos"] = {**row, "gms_gate_kept": [float(g[40:].mean()), float(g[:40].mean())],
                            "inlier_share_and_count": share}

        blob_sig = self.card(self.blob_image([(240, 320)], [30], XFEAT_SHAPE) / 200.0)
        f1, f2 = self.card(self.xfeat_pair[0]), self.card(self.xfeat_pair[1])

        def pct_path():
            s1, s2, s3 = (pct.compute_signature(x) for x in (f1, f2, blob_sig))
            return s1, pct.sqfd(s1, s1), pct.sqfd(s1, s2), pct.sqfd(s1, s3)

        (s1, d11, d12, d13), row = self.xfeat_path("xfeat_pct", pct_path)
        d11, d12, d13 = float(d11), float(d12), float(d13)
        check(d11 < 1e-5 and d13 > 0.01 and abs(float(s1.weights.sum()) - 1.0) < 1e-5,
              f"PCT: sqfd self {d11}, pair {d12}, blob {d13}")
        out["pct"] = {**row, "sqfd_self": d11, "sqfd_pair": d12, "sqfd_blob": d13}

        y0, x0, sz = XFEAT_TM_CUT
        cut = f1[y0:y0 + sz, x0:x0 + sz].clone()

        def template_path():
            return {m: template_match.min_max_loc(template_match.match_template(f1, cut, m))
                    for m in template_match.METHODS}

        locs, row = self.xfeat_path("xfeat_template", template_path)
        for m, use_max in (("ccorr_normed", True), ("sqdiff", False), ("ccoeff", True), ("ccoeff_normed", True),
                           ("sqdiff_normed", False)):
            got = locs[m][3] if use_max else locs[m][2]
            check(got == (y0, x0), f"template {m}: found at {got}, cut at {(y0, x0)}")
        out["template"] = {**row, "cut": [y0, x0, sz], "min_max_loc": {m: [v[0], v[1], list(v[2]), list(v[3])]
                                                                       for m, v in locs.items()}}

        ly, lx = XFEAT_LINEMOD_AT
        scene = np.random.default_rng(0).uniform(0, 0.05, XFEAT_SHAPE).astype(np.float32)
        obj = np.zeros((24, 24), np.float32)
        obj[4:20, 4:8] = 1.0
        obj[16:20, 4:20] = 1.0
        other = scene.copy()
        scene[ly:ly + 24, lx:lx + 24] += obj
        other[ly:ly + 24, lx:lx + 24] += obj.T[::-1]
        sc = self.card(scene)
        q, mag = linemod.quantize_gradients(sc)
        tmpl = linemod.extract_template(q, mag, (ly, lx), (24, 24), n_features=24)
        (boxes, scores), row = self.xfeat_path("xfeat_linemod", lambda: linemod.detect(sc, tmpl, thresh=0.9))
        best = boxes[np.argmax(scores)] if len(scores) else None
        _, s2 = linemod.detect(self.card(other), tmpl, thresh=0.0)
        check(best is not None and abs(best[0] - ly) <= 4 and abs(best[1] - lx) <= 4 and s2.max() < scores.max(),
              f"LINEMOD: best box {best}, rotated object {s2.max()} against {scores.max() if len(scores) else None}")
        out["linemod"] = {**row, "best_box": [int(v) for v in best], "score": float(scores.max()),
                          "rotated_score": float(s2.max()), "detections": int(len(scores))}

        mask = f1 > 140.0

        def ccl_path():
            labels, npass = ccl.connected_components(mask, connectivity=8)
            return labels, npass, ccl.component_stats(labels, f1, max_components=1024)

        (labels, npass, st), row = self.xfeat_path("xfeat_ccl", ccl_path)
        hl, hn = ccl.connected_components(mask.cpu(), connectivity=8)
        hs = ccl.component_stats(hl, f1.cpu(), max_components=1024)
        same = torch.equal(labels.cpu(), hl) and int(npass) == int(hn)
        stats_same = all(torch.equal(st[k].cpu(), hs[k]) for k in ("area", "y0", "x0", "y1", "x1", "cid_map"))
        check(same and stats_same and int(st["valid"].sum()) > 0, f"CCL at VGA: card vs CPU labels {same}, "
                                                                  f"stats {stats_same}")
        out["ccl"] = {**row, "components": int(st["valid"].sum()), "passes": int(npass), "equal_to_cpu": True,
                      "sum_rel_err": float(((st["sum"].cpu() - hs["sum"]).abs().max()
                                            / hs["sum"].abs().max().clamp(min=1)))}
        return out

    def xfeat_compare(self, r, ref, tol, binary: bool) -> dict:
        """Two features_x results on the same frames. Keypoints pair by
        position (1e-3 px), both ways, so that one keypoint more or less
        does not shift the rest; the paired keypoints' descriptors agree,
        and so do their matches (valid alike, and to the same position)."""

        def host(k):
            return np.stack([k.y.cpu().numpy(), k.x.cpu().numpy()], 1), k.valid.cpu().numpy()

        def pairing(a, b):
            (pa, va), (pb, vb) = host(a), host(b)
            ia, ib = np.where(va)[0], np.where(vb)[0]
            if len(ia) == 0 or len(ib) == 0:
                return ia, np.full(len(ia), -1)
            d = np.abs(pa[ia][:, None] - pb[ib][None]).max(-1)
            j = d.argmin(1)
            return ia, np.where(d[np.arange(len(ia)), j] <= 1e-3, ib[j], -1)

        kp = []
        for a, b in ((r.k1, ref.k1), (r.k2, ref.k2)):
            share = [float((pairing(x, y)[1] >= 0).mean()) if int(x.count()) else float(int(y.count()) == 0)
                     for x, y in ((a, b), (b, a))]
            kp.append(min(share))
        ia, j = pairing(r.k1, ref.k1)
        ok = j >= 0
        ia, j = ia[ok], j[ok]
        d1, e1 = r.d1.cpu().numpy(), ref.d1.cpu().numpy()
        if binary:
            desc = float((d1[ia] == e1[j]).mean()) if len(ia) else 1.0
            desc_ok = desc >= tol["bits_agree"]
        else:
            desc = float(np.abs(d1[ia] - e1[j]).max()) if len(ia) else 0.0
            desc_ok = desc <= tol["float_desc"]
        mv, mt = r.matches.valid.cpu().numpy(), r.matches.train_idx.cpu().numpy()
        rv, rt = ref.matches.valid.cpu().numpy(), ref.matches.train_idx.cpu().numpy()
        p2, q2 = host(r.k2)[0], host(ref.k2)[0]
        agree = [mv[i] == rv[k] and (not mv[i] or np.abs(p2[mt[i]] - q2[rt[k]]).max() <= 1e-3) for i, k in zip(ia, j)]
        c = {"kp_paired": kp, "kp": [int(r.k1.count()), int(ref.k1.count())], "desc": desc,
             "valid_agree": float(np.mean(agree)) if agree else 1.0,
             "matches": [int(r.matches.valid.sum()), int(ref.matches.valid.sum())]}
        check(min(kp) >= tol["kp_equal"] and desc_ok and c["valid_agree"] >= tol["valid_agree"]
              and c["matches"][1] > 0, f"features_x compare {c}")
        return c

    def xfeat_plain(self) -> dict:
        """Every features_x path and template matching on integer frames
        0..XFEAT_EXACT_LEVELS, with the kernels and on the plain path."""
        from opencv_contrib_tpu_torch.ops import template_match

        entry = self.entry
        lv = XFEAT_EXACT_LEVELS
        ex = exact_frames(np.stack(self.xfeat_pair[:2]), lv)
        a, b = self.card(ex[0]), self.card(ex[1])
        s = lv / 255.0  # the detectors' absolute thresholds, scaled to the frames
        params = {"fast_hessian": {"threshold": 20.0 * s * s}, "star": {"response_threshold": 10.0 * s},
                  "fast": {"threshold": 20.0 * s}}
        out = {}
        for path, det, desc in self.xfeat_jobs():
            run = lambda det=det, desc=desc: entry.features_x(a, b, det, desc, K=XFEAT_K,  # noqa: E731
                                                              detector_params=params.get(det), device=self.dev)
            r = run()
            with plain_path():
                rp = run()
            out[path] = self.xfeat_compare(r, rp, XFEAT_PLAIN_TOL, desc in self.entry.BINARY_DESCRIPTORS)
        y0, x0, sz = XFEAT_TM_CUT
        cut = a[y0:y0 + sz, x0:x0 + sz].clone()
        tm = {}
        for m in template_match.METHODS:
            r = template_match.match_template(a, cut, m)
            with plain_path():
                rp = template_match.match_template(a, cut, m)
            rel = float((r - rp).abs().max() / (rp.max() - rp.min()))
            locs = template_match.min_max_loc(r)[2:], template_match.min_max_loc(rp)[2:]
            check(rel <= XFEAT_PLAIN_TOL["surface_rel"] and locs[0] == locs[1], f"template {m} plain path: {rel} "
                                                                                f"{locs}")
            tm[m] = rel
        out["template_surface_rel"] = tm
        out["levels"] = lv
        return out

    def xfeat_card_vs_cpu(self) -> dict:
        """Each part at its CPU tests' size on the card and on the CPU."""
        from opencv_contrib_tpu_torch.features import detect_x, match, pct
        from opencv_contrib_tpu_torch.ops import ccl, template_match
        from opencv_contrib_tpu_torch.rgbd import linemod

        torch, entry = self.torch, self.entry
        cpu, tol, out = torch.device("cpu"), XFEAT_CPU_TOL, {}
        i1, i2, _ = entry.feature_pair(*XFEAT_SMALL)
        i1, i2 = np.round(i1), np.round(i2)
        for det, desc in (("fast_hessian", "daisy"), ("harris", "brief"), ("star", "boxes"), ("msd", "lucid"),
                          ("harris_laplace", "freak"), ("fast", "latch"), ("fast_hessian", "vgg"),
                          ("fast_hessian", "boostdesc")):
            prm = {"response_threshold": 5.0} if det == "star" else None
            rc, rh = (entry.features_x(i1, i2, det, desc, K=48, detector_params=prm, device=d) for d in (self.dev, cpu))
            out[f"{det}+{desc}"] = self.xfeat_compare(rc, rh, tol, desc in entry.BINARY_DESCRIPTORS)
        blob = np.round(self.blob_image([(40, 40), (70, 90), (20, 100)], [6, 5, 3], XFEAT_SMALL))
        ec, eh = (detect_x.tbmr(torch.from_numpy(blob).to(d), max_regions=16) for d in (self.dev, cpu))
        v = eh.valid.numpy()
        tb = float(max((ec.y.cpu() - eh.y).abs().numpy()[v].max(), (ec.x.cpu() - eh.x).abs().numpy()[v].max()))
        check(bool(torch.equal(ec.valid.cpu(), eh.valid)) and tb <= tol["tbmr_px"], f"TBMR card vs CPU {tb}")
        out["tbmr_px"] = tb
        sc, sh = (pct.compute_signature(torch.from_numpy(i1).to(d)) for d in (self.dev, cpu))
        pc = float((sc.centroids.cpu() - sh.centroids).abs().max())
        check(pc <= tol["pct"], f"PCT card vs CPU {pc}")
        out["pct"] = pc
        img = np.round(np.random.default_rng(0).uniform(0, 255, (64, 80))).astype(np.float32)
        tmv = {}
        for m in template_match.METHODS:
            rc, rh = (template_match.match_template(torch.from_numpy(img).to(d), torch.from_numpy(img[20:36, 30:50])
                                                    .to(d), m) for d in (self.dev, cpu))
            rel = float((rc.cpu() - rh).abs().max() / (rh.max() - rh.min()))
            check(rel <= tol["surface_rel"] and template_match.min_max_loc(rc)[2:] == template_match.min_max_loc(rh)[2:],
                  f"template {m} card vs CPU {rel}")
            tmv[m] = rel
        out["template_surface_rel"] = tmv
        rng = np.random.default_rng(0)
        scene = rng.uniform(0, 0.05, (96, 96)).astype(np.float32)
        scene[50:70, 30:34] += 1.0
        scene[66:70, 30:50] += 1.0
        lm = []
        for d in (self.dev, cpu):
            q, mag = linemod.quantize_gradients(torch.from_numpy(scene).to(d))
            tmpl = linemod.extract_template(q, mag, (50, 30), (24, 24), n_features=24)
            lm.append((tmpl, linemod.detect(torch.from_numpy(scene).to(d), tmpl, thresh=0.5)))
        (tc, (bc, scc)), (th, (bh, sch)) = lm
        check(torch.equal(tc.offsets.cpu(), th.offsets) and np.array_equal(bc, bh)
              and np.abs(scc - sch).max() <= tol["linemod_score"], "LINEMOD card vs CPU")
        out["linemod_score"] = float(np.abs(scc - sch).max())
        m = rng.uniform(size=(40, 57)) > 0.55
        vals = rng.normal(size=m.shape).astype(np.float32)
        res = []
        for d in (self.dev, cpu):
            lab, npass = ccl.connected_components(torch.from_numpy(m).to(d), connectivity=8)
            res.append((lab.cpu(), int(npass), ccl.component_stats(lab, torch.from_numpy(vals).to(d), 64)))
        (lc, nc, stc), (lh, nh, sth) = res
        check(torch.equal(lc, lh) and nc == nh and all(torch.equal(stc[k].cpu(), sth[k]) for k in
                                                      ("area", "y0", "x0", "y1", "x1", "valid", "cid_map")),
              "CCL card vs CPU")
        out["ccl_equal"] = True
        xy1 = rng.uniform(10, 90, (40, 2)).astype(np.float32)
        xy2 = xy1 + np.array([5.0, -3.0], np.float32)
        xy2[:5] = rng.uniform(10, 90, (5, 2))
        masks = []
        for d in (self.dev, cpu):
            mm = match.Matches(torch.arange(40, dtype=torch.int32, device=d), torch.arange(40, dtype=torch.int32,
                                                                                         device=d),
                               torch.zeros(40, device=d), torch.ones(40, dtype=torch.bool, device=d))
            p1, p2 = torch.from_numpy(xy1).to(d), torch.from_numpy(xy2).to(d)
            masks.append((match.logos_filter(mm, p1, p2).valid.cpu(),
                          match.gms_filter(mm, p1, p2, shape1=(100, 100), shape2=(100, 100), grid=8).valid.cpu()))
        check(all(torch.equal(x, y) for x, y in zip(*masks)), "GMS / LOGOS card vs CPU")
        out["gms_logos_equal"] = True
        return out

    # ---- (t) -----------------------------------------------------------------
    def video(self):
        import tempfile

        out, parts = {}, {}
        t_all = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="video_") as root:
            for name, fn in (("codec", self.video_codec), ("io", lambda: self.video_io(root)),
                             ("path", self.video_path), ("gates", self.video_gates), ("bm3d_1080p", self.video_bm3d),
                             ("card_vs_cpu", self.video_card_vs_cpu)):
                t0 = time.perf_counter()
                out[name] = fn()
                parts[name] = time.perf_counter() - t0
        emit({"phase": "t_video", **out, "phase_parts_s": parts, "phase_s": time.perf_counter() - t_all,
              "tolerance": f"codec: digests equal, PNG routes equal their expansions and the numpy unfilter; clip "
                           f"mean error {VIDEO_MEAN_ERR}; launches {{'streamed_transform': 1, ...VIDEO_PER_FRAME x "
                           f"{VIDEO_CLIP[0]}}}; the path's BRISQUE scores above the clean frames'; BRISQUE mean "
                           f"score rising with each severity; dct_denoise and BM3D "
                           f"PSNR above the noisy frame's; BM3D rerun bit-equal; card vs CPU {VIDEO_CPU_TOL}",
              "timing": "ms: host clock around synchronised calls; device ms from the profiler's kernel events; "
                        "decode ms on the reader's host clock",
              "ok": True})

    @staticmethod
    def codec_frame(H: int, W: int) -> np.ndarray:
        """An RGB uint8 frame of integer arithmetic (the same on every host):
        a wrapped ramp with a product term, and seeded integer noise."""
        yy = np.arange(H, dtype=np.int64)[:, None, None]
        xx = np.arange(W, dtype=np.int64)[None, :, None]
        base = (xx * np.array([3, 5, 7]) + yy * np.array([2, 1, 4]) + (xx * yy) // 97) % 256
        noise = np.random.default_rng(17).integers(-12, 13, (H, W, 3))
        return np.clip(base + noise, 0, 255).astype(np.uint8)

    def video_codec(self) -> dict:
        import hashlib
        import tempfile

        from opencv_contrib_tpu_torch.utils import io as tio
        from opencv_contrib_tpu_torch.utils import jpeg, native, png

        t0 = time.perf_counter()
        jpeg.codec_lib()
        build_s = time.perf_counter() - t0
        f = self.codec_frame(*VIDEO_CLIP[1:])
        rgb = f.astype(np.uint32)
        gray = ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
        jp = {}
        for name, img, q in (("rgb_q75", f, 75), ("rgb_q90", f, 90), ("gray_q75", gray, 75)):
            t0 = time.perf_counter()
            data = jpeg.encode(img, q)
            enc_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            dec = jpeg.decode(data)
            dec_ms = (time.perf_counter() - t0) * 1e3
            got = (hashlib.sha256(data).hexdigest(), hashlib.sha256(dec.tobytes()).hexdigest(), len(data))
            check(got == JPEG_DIGESTS[name], f"JPEG {name}: {got} != {JPEG_DIGESTS[name]}")
            err = float(np.abs(dec.astype(np.int16) - img).mean())
            jp[name] = {"bytes": len(data), "encode_ms": enc_ms, "decode_ms": dec_ms, "mean_abs_err_levels": err}
        # PNGs the native decode expands (palette, low-bit gray, tRNS) and an Adam7 file, from raw chunks
        rng = np.random.default_rng(5)
        H, W = 37, 53
        pal = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        idx = rng.integers(0, 40, (H, W))
        g4 = rng.integers(0, 16, (H, W))
        rgb8 = rng.integers(0, 256, (H, W, 3))
        rgb8[3, :7] = rgb8[0, 0]
        rgb16 = rng.integers(0, 65536, (H, W, 3))
        cases = {"palette": (png.encode_raw(idx, 8, 3, palette=pal), pal[idx], idx.astype(np.uint8)),
                 "gray4": (png.encode_raw(g4, 4, 0), (g4 * 17).astype(np.uint8), (g4 * 17).astype(np.uint8)),
                 "rgb_trns": (png.encode_raw(rgb8, 8, 2, trns=rgb8[0, 0]),
                              np.concatenate([rgb8, np.where((rgb8 == rgb8[0, 0]).all(-1), 0, 255)[..., None]], -1)
                              .astype(np.uint8), rgb8.astype(np.uint8)),
                 "rgb16_adam7": (png.encode_raw(rgb16, 16, 2, interlace=True), rgb16.astype(np.uint16),
                                 (rgb16 >> 8).astype(np.uint8))}
        pngs = {}
        with tempfile.TemporaryDirectory(prefix="png_") as root:
            for name, (data, native_ref, pil_ref) in cases.items():
                path = os.path.join(root, f"{name}.png")
                with open(path, "wb") as fh:
                    fh.write(data)
                check(np.array_equal(png.decode(data), native_ref), f"PNG {name}: the native route's expansion")
                scale = 65535.0 if native_ref.dtype == np.uint16 else 255.0
                check(np.array_equal(native.decode_png(path),
                                     native_ref.astype(np.float32) * (np.float32(1.0) / np.float32(scale))),
                      f"PNG {name}: decode_png")
                check(np.array_equal(tio.imread(path), pil_ref.astype(np.float32) / 255.0), f"PNG {name}: imread")
                with mock.patch.object(png, "unfilter", png.unfilter_numpy):
                    slow = png.decode_raw(data)
                check(np.array_equal(png.decode_raw(data).samples, slow.samples), f"PNG {name}: C++ vs numpy unfilter")
                pngs[name] = {"bytes": len(data), "shape": list(native_ref.shape)}
        return {"host_codec_build_s": build_s, "jpeg": jp, "png": pngs, "frame": list(f.shape)}

    def video_io(self, root: str) -> dict:
        from opencv_contrib_tpu_torch.utils import video

        torch, entry = self.torch, self.entry
        T, H, W = VIDEO_CLIP
        out, self.video_files = {}, {}
        self.video_clean, degraded = entry.photo_clip(T, H, W, seed=0)  # what video_clip writes
        for codec in VIDEO_CODECS:
            t0 = time.perf_counter()
            path, clean = entry.video_clip(root, codec, T, H, W, seed=0)
            write_s = time.perf_counter() - t0
            check(np.array_equal(clean, self.video_clean), "video_clip's clean clip")
            self.video_files[codec] = path
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with video.VideoReader(path, batch=8, device=self.dev) as rdr:
                frames = torch.cat(list(rdr))
                torch.cuda.synchronize()
                read_s = time.perf_counter() - t0
                decode_ms = rdr.decode_s * 1e3 / rdr.frames_decoded
            check(tuple(frames.shape) == (T, H, W, 3) and frames.device.type == self.dev.type, f"{codec} frames")
            err = float((frames - self.card(degraded)).abs().mean())
            check(err < VIDEO_MEAN_ERR[codec], f"{codec} clip mean error {err}")
            out[codec] = {"file_mb": os.path.getsize(path) / 2 ** 20, "write_s": write_s,
                          "reader_frames_per_s": T / read_s, "decode_ms_per_frame": decode_ms,
                          "mean_abs_err": err}
        # the colour conversion on the card against the CPU, on the Y4M file's planes
        planes = list(zip(*video.Y4MReader(self.video_files["y4m"])))
        y, u, v = (torch.from_numpy(np.stack(p)) for p in planes)
        on_card = video.yuv420_to_rgb(y.to(self.dev), u.to(self.dev), v.to(self.dev)).cpu()
        d = float((on_card - video.yuv420_to_rgb(y, u, v)).abs().max())
        check(d <= VIDEO_CPU_TOL["yuv"], f"yuv420_to_rgb card vs CPU {d}")
        out["yuv420_to_rgb_card_vs_cpu_max_abs"] = d
        return out

    def video_path(self) -> dict:
        from torch.profiler import ProfilerActivity, profile

        from opencv_contrib_tpu_torch import quality
        from opencv_contrib_tpu_torch.core.color import rgb_to_gray
        from opencv_contrib_tpu_torch.quality import brisque_svr

        torch, entry = self.torch, self.entry
        T = VIDEO_CLIP[0]
        t0 = time.perf_counter()
        self.video_model = brisque_svr.train_brisque_model(device=self.dev)
        train_s = time.perf_counter() - t0
        cln = self.card(self.video_clean)
        expect = {"streamed_transform": 1, **{k: v * T for k, v in VIDEO_PER_FRAME.items()}}
        # the head's score of each clean frame: the path's frames, degraded and denoised, must score worse
        clean_scores = [brisque_svr.score_features(self.video_model, quality.brisque_features(rgb_to_gray(cln[t])))
                        for t in range(T)]
        out = {"brisque_train_s": train_s, "brisque_clean": clean_scores}
        for codec, pname in VIDEO_CODECS.items():
            path = self.video_files[codec]
            run = lambda: entry.video_photometric(path, cln, model=self.video_model, device=self.dev)  # noqa: E731
            if codec == "y4m":
                run()  # warm-up: cuBLAS, the BRISQUE tables, the allocator
            (res, s), peak = self.peak_gb(lambda: self.counted(pname, run))
            launches = {k: self.launches[pname][k] for k in PATH_KERNELS[pname]}
            check(launches == expect, f"{pname} launches {launches}, expected {expect}")
            check(tuple(res.equalized.shape) == VIDEO_CLIP and len(res.brisque) == T, f"{pname} shapes")
            for k in ("balanced", "equalized", "ssim", "gmsd", "nr_score", "features"):
                check(bool(torch.isfinite(getattr(res, k)).all()), f"{pname} {k} not finite")
            check(all(np.isfinite(res.brisque)) and all(np.isfinite(res.psnr)), f"{pname} scores not finite")
            check(all(b > c for b, c in zip(res.brisque, clean_scores)),
                  f"{pname} BRISQUE {res.brisque} not above the clean frames' {clean_scores}")
            ms = [s * 1e3 / T] + [self.wall_s(run)[1] * 1e3 / T for _ in range(N_VIDEO_TIMED - 1)]
            syncs = self.count_syncs(run)
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall = self.wall_s(run)
            tr = self.kineto_rows(prof, wall, VIDEO_PREFIX, (), require=False)  # raw events: no event tree
            out[codec] = {"s_main_path": s, "launches": self.launches[pname], "launches_per_clip": launches,
                          "ms_per_frame": ms, "ms_per_frame_median": float(np.median(ms)),
                          "device_ms_per_frame": tr["device_busy_s"] * 1e3 / T,
                          "device_busy_share": tr["device_busy_share"],
                          "device_launches_per_frame": tr["device_launches"] / T, "top_device": tr["top_device"],
                          "profile_s": time.perf_counter() - t0,
                          "decode_ms_per_frame": res.decode_ms, "host_syncs_run": syncs,
                          "host_syncs_per_frame": syncs["in_the_port"] / T, "peak_mem_of_a_run_gb": peak,
                          "psnr": res.psnr, "brisque": res.brisque, "ssim": res.ssim.tolist()}
        return out

    def video_gates(self) -> dict:
        from opencv_contrib_tpu_torch import quality, xphoto
        from opencv_contrib_tpu_torch.core.color import rgb_to_gray
        from opencv_contrib_tpu_torch.quality import brisque_svr as bs

        torch = self.torch
        # the trained head on held-out images (tests/test_brisque_svr.py:24-29), its features on the card
        rng = np.random.default_rng(123)
        sev = {}
        for kind in ("blur", "noise", "jpeg"):
            scores = np.mean([[bs.brisque_score(self.video_model, bs.distort(base, kind, k, rng), device=self.dev)
                               for k in range(5)] for base in [bs.natural_texture(rng) for _ in range(4)]], axis=0)
            check(bool(np.all(np.diff(scores) > 0)), f"BRISQUE {kind} scores {scores} do not rise with severity")
            sev[kind] = scores.tolist()
        # dct_denoise at 1080 x 1920 (tests/test_imgproc_modules.py:29's gate)
        clean = rgb_to_gray(self.card(self.video_clean[0]))
        gen = torch.Generator(device=self.dev).manual_seed(0)
        noisy = clean + VIDEO_NOISE["dct"] * torch.randn(clean.shape, generator=gen, device=self.dev)
        out = xphoto.dct_denoise(noisy, sigma=VIDEO_NOISE["dct"])
        e_in, e_out = float((noisy - clean).abs().mean()), float((out - clean).abs().mean())
        check(e_out < e_in, f"dct_denoise at 1080p: mean error {e_out} not below {e_in}")
        return {"brisque_mean_score_by_severity": sev, "dct_denoise_mean_err": [e_in, e_out],
                "dct_denoise_psnr_db": [quality.psnr(noisy, clean), quality.psnr(out, clean)]}

    def video_bm3d(self) -> dict:
        from opencv_contrib_tpu_torch import quality, xphoto
        from opencv_contrib_tpu_torch.core.color import rgb_to_gray

        torch = self.torch
        clean = rgb_to_gray(self.card(self.video_clean[0]))
        gen = torch.Generator(device=self.dev).manual_seed(1)
        sigma = VIDEO_NOISE["bm3d"]
        noisy = clean + sigma * torch.randn(clean.shape, generator=gen, device=self.dev)
        xphoto.bm3d(noisy[:256, :256], sigma)  # warm-up: cuBLAS, the sort
        (first, s1), peak = self.peak_gb(lambda: self.wall_s(lambda: xphoto.bm3d(noisy, sigma)))
        second, s2 = self.wall_s(lambda: xphoto.bm3d(noisy, sigma))
        check(bool(torch.equal(first, second)), "BM3D at 1080p: a rerun gave other bits")
        e_in, e_out = float((noisy - clean).abs().mean()), float((first - clean).abs().mean())
        p_in, p_out = quality.psnr(noisy, clean), quality.psnr(first, clean)
        check(p_out > p_in and e_out < e_in, f"BM3D at 1080p: PSNR {p_out} dB from {p_in}")
        syncs = self.count_syncs(lambda: xphoto.bm3d(noisy, sigma))
        return {"shape": list(clean.shape), "sigma": sigma, "s": [s1, s2], "peak_mem_gb": peak,
                "rerun_bit_equal": True, "psnr_db": [p_in, p_out], "mean_err": [e_in, e_out],
                "host_syncs": syncs}

    def video_card_vs_cpu(self) -> dict:
        from opencv_contrib_tpu_torch import xphoto
        from opencv_contrib_tpu_torch.quality import brisque_svr as bs

        torch, cpu, tol = self.torch, self.torch.device("cpu"), VIDEO_CPU_TOL
        rng = np.random.default_rng(7)
        T, H, W = VIDEO_SMALL
        img = np.clip(np.kron(rng.random((H // 6 + 1, W // 6 + 1)), np.ones((6, 6)))[:H, :W]
                      + rng.normal(0, 0.08, (H, W)), 0, 1).astype(np.float32)
        rgb = rng.random((H, W, 3)).astype(np.float32)
        mask = rng.random((H, W)) < 0.2

        def both(fn, *arrays):
            return [fn(*(torch.from_numpy(a).to(d) for a in arrays)) for d in (self.dev, cpu)]

        def dmax(a, b):
            return float((a.cpu() - b).abs().max())

        out = {}
        out["dct"] = dmax(*both(lambda x: xphoto.dct_denoise(x, 0.08), img))
        out["inpaint"] = dmax(*both(lambda x, m: xphoto.inpaint_diffusion(x, m), img, mask))
        oc, oh = both(xphoto.oil_painting, img)
        out["oil_share_off"] = float(((oc.cpu() - oh).abs() > 1e-6).float().mean())
        wb_model = torch.from_numpy(rng.normal(0, 0.1, (8, 2)).astype(np.float32)) + torch.tensor(
            [[0.33, 0.33]] + [[0.0, 0.0]] * 7)
        (bc, ic), (bh, ih) = both(lambda x: xphoto.learning_wb(x, wb_model), rgb)
        out["wb"] = max(dmax(bc, bh), dmax(ic, ih))
        out["bm3d"] = dmax(*both(lambda x: xphoto.bm3d(x, 0.08), img))
        tex = bs.distort(bs.natural_texture(rng), "noise", 2, rng)
        out["brisque"] = abs(bs.brisque_score(self.video_model, tex, device=self.dev)
                             - bs.brisque_score(self.video_model, tex, device="cpu"))
        for k, v in out.items():
            check(v <= tol[k], f"{k} card vs CPU {v} > {tol[k]}")
        return out

    # ---- (u) -----------------------------------------------------------------
    def ximgproc(self):
        """Phase u: every method of entry.ximgproc_frame on
        entry.structure_frame() at VGA on the card (graph segmentation and
        selective search on the frame at XIMG_CUT), the JAX tests' gates,
        bit-equal reruns, the learned edge map trained on the card, one
        profiler window over every method, and the port's CPU run of each
        (`ximg_cpu_outputs`, made in a process of its own while the card
        runs, with the card's edge model) against the card's."""
        import concurrent.futures
        import multiprocessing

        from opencv_contrib_tpu_torch.ximgproc import edge_forest

        entry = self.entry
        t_all = time.perf_counter()
        frames = {shape: entry.structure_frame(*shape) for shape in {XIMG_SHAPE, *XIMG_CUT.values()}}
        t0 = time.perf_counter()
        params, train_s = self.wall_s(lambda: edge_forest.train(device=self.dev))
        edge_forest._DEFAULT_PARAMS[str(self.dev)] = params
        parts = {"edge_forest_train": time.perf_counter() - t0}
        pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        try:
            cpu_job = pool.submit(ximg_cpu_outputs, {k: v.cpu().numpy() for k, v in params.items()},
                                  XIMG_CPU_THREADS)
            return self._ximgproc_card(edge_forest, frames, train_s, parts, t_all, cpu_job)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _ximgproc_card(self, edge_forest, frames, train_s, parts, t_all, cpu_job):
        """Phase u past the edge model's training: the card's runs, profile
        and gates, then the CPU run's outputs (`cpu_job`) against the card's."""
        torch, entry = self.torch, self.entry
        on_card = {shape: (self.card(f.rgb), self.card(f.disparity)) for shape, f in frames.items()}
        t0 = time.perf_counter()
        train_check = self.ximg_train_check(edge_forest, self.card(frames[XIMG_SHAPE].rgb))
        parts["edge_forest_train_vs_cpu"] = time.perf_counter() - t0

        def call(m):
            rgb, disp = on_card[XIMG_CUT.get(m, XIMG_SHAPE)]
            return entry.ximgproc_frame(rgb, m, device=self.dev, disparity=disp)

        t0 = time.perf_counter()
        runs, outs = {}, {}
        for m in entry.METHODS:
            self.kern.reset_launches()
            (out, s1), peak = self.peak_gb(lambda: self.wall_s(lambda: call(m)))
            launches = {k: v for k, v in self.kern.launches().items() if v}
            check(launches == {"grid_transform": 1}, f"ximgproc {m}: kernel launches {launches}, expected the "
                                                     f"gray conversion's one grid_transform")
            with self.sync_log() as got:
                again, s2 = self.wall_s(lambda: call(m))
            syncs = self.sync_summary(got)
            same = self.ximg_equal(out, again)
            check(same or m not in XIMG_LABELS, f"ximgproc {m}: a rerun gave another label map")
            outs[m] = out
            runs[m] = {"shape": list(XIMG_CUT.get(m, XIMG_SHAPE)), "ms_first": s1 * 1e3, "ms": s2 * 1e3,
                       "peak_mem_gb": peak, "host_syncs": syncs["total"], "host_syncs_in_port": syncs["in_the_port"],
                       "sync_sites": syncs["top_sites"], "rerun_bit_equal": same, "grid_transform_launches": 1}
        parts["card_runs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prof = self.ximg_profile({m: (lambda m=m: call(m)) for m in entry.METHODS})
        for m, row in prof.items():
            top = sorted(row["kernels"].items(), key=lambda kv: -kv[1][1])[:5]
            runs[m].update(device_ms=row["device_ms"], device_launches=row["launches"],
                           costliest={k[:80]: [n, ms] for k, (n, ms) in top})
        parts["profile"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gates = self.ximg_gates(outs, frames)
        parts["gates"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = cpu_job.result(timeout=600)
        parts["cpu_wait"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu, beyond = {}, {}
        for m in entry.METHODS:
            d = self.ximg_diff(outs[m], tuple(torch.from_numpy(v) if isinstance(u, torch.Tensor) else v
                                              for u, v in zip(self._leaves(outs[m]), host[m])))
            tol = {**XIMG_CPU_TOL["default"], **XIMG_CPU_TOL.get(m, {})}
            cpu[m] = {k: v for k, v in d.items() if v}
            if any(d[k] > tol[k] for k in d):
                beyond[m] = cpu[m]
        parts["card_vs_cpu"] = time.perf_counter() - t0
        if any(train_check[k] > XIMG_TRAIN_TOL[k] for k in XIMG_TRAIN_TOL):
            beyond["edge_forest_train"] = train_check
        ok = not beyond
        emit({"phase": "u_ximgproc", "ok": ok, "card_vs_cpu_beyond_tolerance": beyond, "frame": list(XIMG_SHAPE),
              "cut": {m: list(s) for m, s in XIMG_CUT.items()},
              "edge_forest_train_s": train_s, "edge_forest_train_vs_cpu": train_check, "methods": runs, "gates": gates, "card_vs_cpu": cpu,
              "rerun_bit_equal_all": all(r["rerun_bit_equal"] for r in runs.values()),
              "phase_parts_s": parts, "phase_s": time.perf_counter() - t_all,
              "tolerance": f"launches: one grid_transform (the gray conversion) a call, no other kernel of ours; "
                           f"label maps {sorted(XIMG_LABELS)} bit-equal on a rerun; gates: the JAX tests' at VGA "
                           f"(ximg_gates); card vs CPU: {XIMG_CPU_TOL}; training card vs CPU {XIMG_TRAIN} "
                           f"within {XIMG_TRAIN_TOL}",
              "timing": "ms: host clock around a synchronised warm call (ms_first: the first call); device_ms and "
                        "device_launches: one profiler window over every method (raw kineto events, kernels joined "
                        "to record_function spans); peak_mem_gb: the first call's peak above what was held"})
        check(ok, f"ximgproc card vs CPU beyond tolerance: {beyond}")

    def ximg_train_check(self, edge_forest, rgb) -> dict:
        """The edge MLP trained on the card and on the CPU from the same
        initial draws and scenes (XIMG_TRAIN): the largest difference of the
        parameters and of the maps they give on the frame's gray."""
        from opencv_contrib_tpu_torch.core.color import rgb_to_gray

        torch = self.torch
        card = edge_forest.train(device=self.dev, **XIMG_TRAIN)
        host = edge_forest.train(device="cpu", **XIMG_TRAIN)
        gray = rgb_to_gray(rgb)
        maps = [edge_forest.structured_edges(gray, card).cpu(), edge_forest.structured_edges(gray.cpu(), host)]
        return {"params": max(float((card[k].cpu() - host[k]).abs().max()) for k in host),
                "moved": min(float((host[k] - v).abs().max()) for k, v in edge_forest.init_params(
                    host["W1"].shape[0], host["W1"].shape[1]).items()),
                "map": float((maps[0] - maps[1]).abs().max())}

    def ximg_profile(self, calls: dict) -> dict:
        """Device ms, launches and kernels of each call in `calls`, from one
        profiler window of device activity only: the calls run in order on
        one stream, each after two int16 fills (XIMG_MARKER) that no call
        launches, so the kernels between two groups of fills are one call's.
        Recording the host's ops too cost ~50 s for phase u's ~300,000
        launches on the H100); the window opens with DIST_MARKERS uint8
        fills, as every late window here does (a trace drops its first
        events). A window whose trace holds another number of marker groups
        than calls + 1 is taken again, at most N_WINDOWS times (one of the
        H100's runs read 54 groups for phase u's 50 calls). Returns
        {name: {device_ms, launches, kernels}}."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        if self.marker is None:
            self.marker = torch.empty(16, dtype=torch.uint8, device=self.dev)
        sep = torch.empty(16, dtype=torch.int16, device=self.dev)
        names, seen = list(calls), []
        for _ in range(N_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(WINDOW_PAD_S)
                for _ in range(DIST_MARKERS):
                    self.marker.zero_()
                for name in names:
                    sep.zero_()
                    sep.zero_()
                    calls[name]()
                sep.zero_()
                torch.cuda.synchronize()
                time.sleep(WINDOW_PAD_S)
                t_run = time.perf_counter()
            t_stop = time.perf_counter()
            results = prof.profiler.kineto_results
            events = sorted((e.start_ns(), e.name(), e.duration_ns()) for e in results.events()
                            if e.device_type() == DeviceType.CUDA)
            # where a window's seconds go: the calls under the profiler, its stop, reading its events
            self.profile_split = {"run_s": t_run - t0, "stop_s": t_stop - t_run,
                                  "read_s": time.perf_counter() - t_stop, "events": len(events)}
            rows = marker_groups(events)
            if len(rows) == len(names) + 1:
                if seen:
                    self.retaken.append(seen)
                return dict(zip(names, rows))
            start = results.trace_start_ns() if hasattr(results, "trace_start_ns") else None
            seen.append({"marker_groups": len(rows), "calls": len(names), "events": len(events),
                         "before_trace_start": None if start is None else sum(t < start for t, _, _ in events),
                         "group_fills": [r["fills"] for r in rows if r["fills"] != 2][:10]})
        raise AssertionError(f"profile: no window held one marker group a call: {seen}")

    @staticmethod
    def _leaves(x):
        return list(x) if isinstance(x, tuple) else [x]

    def ximg_equal(self, a, b) -> bool:
        """Two results of one method hold the same bits."""
        for u, v in zip(self._leaves(a), self._leaves(b)):
            if isinstance(u, self.torch.Tensor):
                if not self.torch.equal(u, v):
                    return False
            elif not np.array_equal(np.asarray(u), np.asarray(v)):
                return False
        return True

    def ximg_diff(self, card, host) -> dict:
        """How a card result parts from the CPU's: float tensors by their
        largest difference relative to the CPU's range (`rel`) and the share
        of entries that differ by more than 1e-4 of it (`px_off`), boolean masks
        by the share of pixels that differ (`mask_off`), integer label maps by
        the share of pixels whose labels differ (`labels_off`), host arrays
        (boxes, lines, circles, regions) by whether their shapes agree
        (`shape_off`) and their largest difference (`host_abs`)."""
        torch = self.torch
        out = {"rel": 0.0, "px_off": 0.0, "mask_off": 0.0, "labels_off": 0.0, "shape_off": 0.0, "host_abs": 0.0}
        for u, v in zip(self._leaves(card), self._leaves(host)):
            if isinstance(u, torch.Tensor):
                u = u.cpu()
                if u.dtype == torch.bool:
                    out["mask_off"] = max(out["mask_off"], float((u != v).float().mean()))
                elif u.is_floating_point():
                    scale = max(float(v.max() - v.min()) if v.numel() else 0.0, 1e-6)
                    d = (u - v).abs()
                    out["rel"] = max(out["rel"], float(d.max()) / scale if u.numel() else 0.0)
                    out["px_off"] = max(out["px_off"], float((d > 1e-4 * scale).float().mean()) if u.numel() else 0.0)
                else:
                    out["labels_off"] = max(out["labels_off"], float((u != v).float().mean()))
            else:
                u, v = np.asarray(u), np.asarray(v)
                if u.shape != v.shape:
                    out["shape_off"] = 1.0
                elif u.ndim == 2 and u.dtype.kind in "iu" and u.shape[0] > 16:
                    out["labels_off"] = max(out["labels_off"], float((u != v).mean()))
                elif u.size:
                    out["host_abs"] = max(out["host_abs"], float(np.abs(u.astype(np.float64) - v).max()))
        return out

    def ximg_gates(self, outs, frames) -> dict:
        """The JAX tests' gates on the VGA frame (selective search on the cut
        frame): ED lines, ED circles, Hough lines, findEllipses, selective
        search, EdgeBoxes on the learned map, SWT, FGS and the WLS filter."""
        from opencv_contrib_tpu_torch.core.color import rgb_to_gray

        f = frames[XIMG_SHAPE]
        L = f.layout
        out = {}
        # ED lines: the band edge and both sides of the bar (tests/test_ximgproc2.py::test_ed_lines_finds_segments)
        lines = outs["ed_lines"]
        dy, dx = np.abs(lines[:, 2] - lines[:, 0]), np.abs(lines[:, 3] - lines[:, 1])
        horiz = (dx > 5 * dy) & (np.abs((lines[:, 0] + lines[:, 2]) / 2 - (L["band"] - 0.5)) < 2.0)
        ly0, lx0, ly1, lx1 = L["line"]
        xm = (lines[:, 1] + lines[:, 3]) / 2
        vert = [(dy > 5 * dx) & (np.abs(xm - x) < 2.0) & (lines[:, 4] < 1.0) for x in (lx0 - 0.5, lx1 + 0.5)]
        check(horiz.any() and all(v.any() for v in vert), f"ED lines: the band edge {horiz.any()}, the bar's sides "
                                                          f"{[bool(v.any()) for v in vert]} in {lines.tolist()}")
        out["ed_lines"] = {"n": int(lines.shape[0]), "band_edge": lines[horiz][0].tolist(),
                           "bar_sides": [lines[v][0].tolist() for v in vert]}
        # ED circles: the disc found, no large circle on the band edge or the bar (the JAX test's line)
        circ = outs["ed_circles"]
        cy, cx, r = L["circle"]
        near = np.hypot(circ[:, 0] - cy, circ[:, 1] - cx) < 2
        best = circ[near][np.argmin(np.abs(circ[near, 2] - r))] if near.any() else None
        on_line = (((np.abs(circ[:, 1] - (lx0 + lx1) / 2) < 3) & (circ[:, 0] > ly0) & (circ[:, 0] < ly1))
                   | (np.abs(circ[:, 0] - L["band"]) < 3)) & (circ[:, 2] > 20)
        check(best is not None and abs(best[2] - r) < 2 and not on_line.any(), f"ED circles {circ.tolist()}")
        out["ed_circles"] = {"n": int(circ.shape[0]), "disc": best.tolist()}
        # Hough: the band edge is the accumulator's peak (tests/test_ximgproc.py::test_hough_finds_line)
        acc, th, rho = (v.cpu().numpy() for v in outs["fast_hough_lines"])
        ai, ri = np.unravel_index(acc.argmax(), acc.shape)
        bin_w = rho[1] - rho[0]
        check(abs(th[ai] - np.pi / 2) < 0.1 and abs(rho[ri] - L["band"]) <= bin_w,
              f"Hough peak theta {th[ai]}, rho {rho[ri]} (band at {L['band']}, bin {bin_w})")
        out["hough_lines"] = {"theta": float(th[ai]), "rho": float(rho[ri]), "votes": float(acc.max())}
        # findEllipses (tests/test_ximgproc3.py::TestFindEllipses)
        ells, scores = (v.cpu().numpy() for v in outs["find_ellipses"])
        ecx, ecy, ea, eb = L["ellipse"]
        e = ells[scores.argmax()]
        check(scores.max() > 0.5 and abs(e[0] - ecx) < 3 and abs(e[1] - ecy) < 3 and abs(max(e[2:4]) - ea) < 4
              and abs(min(e[2:4]) - eb) < 4, f"findEllipses {ells.tolist()} scores {scores.tolist()}")
        out["find_ellipses"] = {"ellipse": e.tolist(), "score": float(scores.max())}
        # selective search covers the object (tests/test_ximgproc2.py::test_selective_search_covers_object)
        gt = np.array(frames[XIMG_CUT["selective_search"]].layout["box"])
        best_iou = 0.0
        for p in outs["selective_search"]:
            y0, x0, y1, x1 = max(p[0], gt[0]), max(p[1], gt[1]), min(p[2], gt[2]), min(p[3], gt[3])
            inter = max(y1 - y0 + 1, 0) * max(x1 - x0 + 1, 0)
            union = (p[2] - p[0] + 1) * (p[3] - p[1] + 1) + (gt[2] - gt[0] + 1) * (gt[3] - gt[1] + 1) - inter
            best_iou = max(best_iou, inter / union)
        check(best_iou > 0.5, f"selective search: best IoU {best_iou}")
        out["selective_search"] = {"proposals": len(outs["selective_search"]), "best_iou": best_iou}
        # EdgeBoxes on the learned map prefers the tight box (tests/test_ximgproc2.py::test_edge_boxes_prefers_...)
        s = outs["edge_boxes"]
        check(s[0] > s[1] and s[0] > s[2], f"EdgeBoxes scores {s.tolist()} (tight, empty, inside)")
        out["edge_boxes"] = s.tolist()
        # SWT groups the glyph bars into one line (tests/test_text.py::test_detect_groups_letters_into_line)
        boxes, letters = outs["detect_text"]
        gy0, gy1, gxs, stroke = L["glyphs"]
        check(boxes.shape[0] >= 1 and letters.shape[0] >= 3, f"SWT boxes {boxes.tolist()}, letters {letters.shape}")
        b = boxes[np.argmax(boxes[:, 3] - boxes[:, 1])]
        check(b[0] <= gy0 + 2 and b[2] >= gy1 - 4 and b[1] <= gxs[0] + 3 and b[3] >= gxs[-1] - 2,
              f"SWT word box {b.tolist()} against the glyphs {L['text']}")
        out["detect_text"] = {"box": b.tolist(), "letters": int(letters.shape[0])}
        # FGS and the WLS filter smooth but keep the edge (tests/test_ximgproc3.py::TestFGS, TestDisparityWLS)
        gray = rgb_to_gray(self.card(f.rgb)).cpu().numpy()
        fgs = outs["fast_global_smoother"].cpu().numpy()
        band = L["band"]
        flat = (slice(200, 280), slice(150, 500))  # a patch of the upper band with no element
        step_in, step_out = (float(x[band + 10:band + 20, :300].mean() - x[band - 20:band - 10, :300].mean())
                             for x in (gray, fgs))
        check(fgs[flat].std() < 0.5 * gray[flat].std() and step_out > 0.8 * step_in,
              f"FGS: flat std {fgs[flat].std()} of {gray[flat].std()}, step {step_out} of {step_in}")
        wls, conf = (v.cpu().numpy() for v in outs["disparity_wls_filter"])
        dl = f.disparity[0]
        holes = dl == 0
        upper = np.zeros_like(holes)
        upper[:band - 10] = True
        err_holes = float(np.abs(wls[holes & upper] - 8.0).max())
        wls_step = float(wls[band + 10:band + 20].mean() - wls[band - 20:band - 10].mean())
        check(err_holes < 0.5 and wls[flat].std() < 0.1 and wls_step > 3.0,
              f"WLS: hole error {err_holes}, flat std {wls[flat].std()}, step {wls_step}")
        out["fgs"] = {"flat_std": [float(gray[flat].std()), float(fgs[flat].std())], "step": [step_in, step_out]}
        out["wls"] = {"hole_err_upper_band": err_holes, "flat_std": float(wls[flat].std()), "step": wls_step,
                      "conf_mean": float(conf.mean())}
        return out

    # ---- (v) -----------------------------------------------------------------
    def geometry(self):
        """Phase v: every method of entry.geometry_x on entry.geometry_scene()
        at VGA on the card: counted (GEO_LAUNCHES: knn2 on the random
        pattern, pyrdown on the reg models, no kernel of ours elsewhere),
        timed, its host syncs and peak memory, rerun bit-equal; one profiler
        window over every method (device ms, launches); the JAX tests'
        gates at VGA (`geometry_gates`); the port's CPU run of each method,
        made in a process of its own while the card runs, against the
        card's (`geometry_diff`, GEO_CPU_TOL; the random pattern on both
        from one CPU generator's draws)."""
        import concurrent.futures
        import multiprocessing

        from opencv_contrib_tpu_torch.mvg import robust

        torch, entry = self.torch, self.entry
        check(tuple(entry.GEOMETRY) == GEO_METHODS, f"entry.GEOMETRY {tuple(entry.GEOMETRY)} != GEO_METHODS")
        t_all = time.perf_counter()
        pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        try:
            cpu_job = pool.submit(geometry_cpu_outputs, GEO_SHAPE, GEO_CPU_THREADS)
            scene = entry.geometry_scene(*GEO_SHAPE)
            on_card = scene._replace(**{k: self.card(v) for k, v in scene._asdict().items()
                                        if isinstance(v, np.ndarray) and v.dtype.kind == "f"
                                        and k not in entry.GEO_HOST_FIELDS})
            parts = {"scene": time.perf_counter() - t_all}

            def call(m):
                return entry.geometry_x(on_card, m, device=self.dev)

            t0 = time.perf_counter()
            runs, outs = {}, {}
            for m in GEO_METHODS:
                (out, s1), peak = self.peak_gb(lambda: self.counted(f"geometry_{m}", lambda: call(m)))
                launches = {k: v for k, v in self.launches[f"geometry_{m}"].items() if v}
                check(launches == GEO_LAUNCHES.get(m, {}), f"geometry {m}: kernel launches {launches}, expected "
                                                           f"{GEO_LAUNCHES.get(m, {})}")
                with self.sync_log() as got:
                    again, s2 = self.wall_s(lambda: call(m))
                syncs = self.sync_summary(got)
                same = _geo_equal(out, again)
                outs[m] = out
                runs[m] = {"ms_first": s1 * 1e3, "ms": s2 * 1e3, "peak_mem_gb": peak, "host_syncs": syncs["total"],
                           "host_syncs_in_port": syncs["in_the_port"], "sync_sites": syncs["top_sites"],
                           "rerun_bit_equal": same, "kernel_launches": launches}
            parts["card_runs"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            prof = self.ximg_profile({m: (lambda m=m: call(m)) for m in GEO_METHODS})
            for m, row in prof.items():
                top = sorted(row["kernels"].items(), key=lambda kv: -kv[1][1])[:3]
                runs[m].update(device_ms=row["device_ms"], device_launches=row["launches"],
                               costliest={k[:60]: [n, ms] for k, (n, ms) in top})
            parts["profile"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            try:
                gates, gates_missed = geometry_gates(scene, outs), None
            except AssertionError as e:  # reported with the phase's readings, then raised
                gates, gates_missed = None, str(e)
            parts["gates"] = time.perf_counter() - t0
            with _same_draws(robust, torch):  # the random pattern again, on the CPU run's draws
                same_draws = _geo_host(call("find_correspondences"))
            t0 = time.perf_counter()
            host = cpu_job.result(timeout=600)
            parts["cpu_wait"] = time.perf_counter() - t0
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        cpu, beyond = {}, {}
        for m in GEO_METHODS:
            card = same_draws if m == "find_correspondences" else _geo_host(outs[m])
            cpu[m] = geometry_diff(m, card, host[m], scene)
            if not cpu[m]["ok"]:
                beyond[m] = cpu[m]
        not_equal = sorted(m for m, r in runs.items() if not r["rerun_bit_equal"])
        ok = not beyond and not not_equal and not gates_missed
        emit({"phase": "v_geometry", "ok": ok, "card_vs_cpu_beyond_tolerance": beyond,
              "rerun_not_bit_equal": not_equal, "gates_missed": gates_missed, "frame": list(GEO_SHAPE),
              "methods": runs, "gates": gates,
              "card_vs_cpu": cpu, "phase_parts_s": parts, "phase_s": time.perf_counter() - t_all,
              "tolerance": f"launches: {GEO_LAUNCHES} a call, no other kernel of ours; every result bit-equal on a "
                           f"rerun; gates: the JAX tests' at VGA (geometry_gates); card vs CPU: {GEO_CPU_TOL} "
                           f"(geometry_diff)",
              "timing": "ms: host clock around a synchronised warm call (ms_first: the first call, counted); "
                        "device_ms and device_launches: one profiler window over every method (raw kineto "
                        "events); peak_mem_gb: the first call's peak above what was held; the CPU run went on "
                        f"in a process of its own ({GEO_CPU_THREADS} threads) while these ran"})
        check(ok, f"geometry: card vs CPU beyond tolerance {beyond}, reruns not bit-equal {not_equal}, gates "
                  f"{gates_missed}")

    # ---- (w) -----------------------------------------------------------------
    def track_cpu_start(self):
        """Start phase w's CPU run (`track_cpu_outputs`), then phase x's
        (`x_cpu_outputs`) and phase y's (`y_cpu_outputs`) and phase z's QR
        draws (`z_training_data`), in a spawned process of their own at a
        low priority; main() starts them before phase u, so that they run
        beside phases u to y's card work (phase w, x, y or z starts its own
        when run alone). `close` ends them: phase z, which queues its CPU
        run there too, or phase x / y when run without the later phases."""
        import multiprocessing

        # at niceness 10 the CPU run takes the cores the card's phases leave idle (beside them at the default
        # priority it slowed phase v by 14 s and phase w's host work 5-fold on a slow host)
        self.track_pool = multiprocessing.get_context("spawn").Pool(1, initializer=os.nice, initargs=(10,))
        self.track_cpu_job = self.track_pool.apply_async(track_cpu_outputs,
                                                         (TRACK_SHAPE, TRACK_FRAMES, TRACK_CPU_THREADS))
        # phase x's CPU run, queued behind phase w's in the same process, and phase y's behind it
        self.x_cpu_job = self.track_pool.apply_async(x_cpu_outputs, (X_SHAPE, X_CPU_THREADS))
        self.y_cpu_job = self.track_pool.apply_async(y_cpu_outputs, (Y_SHAPE, Y_CPU_THREADS))
        # the QR recipes' host draws for phase z, made here ahead of its training, and phase z's CPU run (the
        # trained weights) queued behind them; phase z ends the pool
        self.z_data_job = self.track_pool.apply_async(z_training_data)
        self.z_queued = True
        self.track_cpu_t0 = time.perf_counter()

    def close(self):
        """End the processes the phases started that may still run."""
        pool = getattr(self, "track_pool", None)
        if pool is not None:
            pool.terminate()
            pool.join()
            self.track_pool = self.x_cpu_job = self.y_cpu_job = self.z_data_job = None

    def integral_batched(self) -> dict:
        """The integral kernel on the batches of tables MIL's and Boosting's
        steps give it (INTEGRAL_BATCHES): one launch a call, of the
        one-block-a-table kernel; bit-equal to the plain version on integer
        patches (tables below 2**24); bit-equal to the slab kernel on the
        batch and to one slab launch a table, on integer and float patches;
        on float patches within phase c's 2e-6 of the largest entry of the
        plain version. Timed L2-warm beside the slab kernel, the plain
        version and two cumsums over the batch, INTEGRAL_REPS calls each, in
        one profiler window (`ximg_profile`: a window of its own a call
        costs about a second this late in the process); L2-cold at the
        first shape."""
        import torch.nn.functional as F

        from opencv_contrib_tpu_torch.ops.cuda import scan

        torch = self.torch
        rows, calls, fns = {}, {}, {}
        slabs = lambda a: scan._integral(a, 1, "integral_padded", slabs_only=True)  # noqa: E731
        for N, H, W in INTEGRAL_BATCHES:
            check(scan.one_block(H, W), f"batched integral {N}x{H}x{W}: not one block a table")
            for kind, x in (("integer", self.card(np.round(self.gen.uniform(0, 255, size=(N, H, W))))),
                            ("float", self.card(self.gen.uniform(0, 1, size=(N, H, W))))):
                out, ref = scan.integral_padded(x), scan.integral_padded_plain(x)
                singles = torch.stack([slabs(x[i]) for i in range(N)])
                torch.cuda.synchronize()
                err, top = float((out - ref).abs().max()), float(ref.abs().max())
                check(err <= (0.0 if kind == "integer" else 2e-6 * top) and torch.equal(scan.integral_padded(x), out)
                      and torch.equal(out, slabs(x)) and torch.equal(out, singles),
                      f"batched integral {N}x{H}x{W} ({kind} patches): max err {err} (max {top}); a rerun, the "
                      f"slab kernel on the batch and {N} single slab launches equal")
            key = f"{N}x{H}x{W}"
            fns[key] = {"": lambda x=x: scan.integral_padded(x), "slabs_": lambda x=x: slabs(x),
                        "plain_": lambda x=x: scan.integral_padded_plain(x),
                        "library_": lambda x=x: F.pad(torch.cumsum(torch.cumsum(x, 1), 2), (1, 0, 1, 0))}
            for prefix, fn in fns[key].items():
                calls[f"{key}/{prefix}"] = lambda fn=fn: [fn() for _ in range(INTEGRAL_REPS)]
            rows[key] = {"shape": [N, H, W], "max_abs_err": err, "max_abs": top, "integer_exact": True,
                         "equal_to_slab_kernel": True, "equal_to_single_slab_launches": True,
                         "bound_ms": 4 * N * (H * W + (H + 1) * (W + 1)) / self.bw * 1e3, "bound_by": "bytes"}
        for fn in calls.values():  # warm
            fn()
        prof = self.ximg_profile(calls)
        for name, r in prof.items():
            key, prefix = name.split("/")
            if prefix in ("", "slabs_"):
                kname = "integral_table_kernel" if prefix == "" else "integral_kernel"
                check(r["launches"] == INTEGRAL_REPS and all(is_ours(k, kname) for k in r["kernels"]),
                      f"batched integral {key} ({prefix or 'table'}): {r['launches']} launches of "
                      f"{list(r['kernels'])} in {INTEGRAL_REPS} calls")
                rows[key][prefix + "launches_per_call"] = r["launches"] / INTEGRAL_REPS
            rows[key][prefix + "ms"] = r["device_ms"] / INTEGRAL_REPS
        first = f"{INTEGRAL_BATCHES[0][0]}x{INTEGRAL_BATCHES[0][1]}x{INTEGRAL_BATCHES[0][2]}"
        for prefix in ("", "library_"):
            rows[first][prefix + "cold_ms"] = self.device_ms(fns[first][prefix], iters=30, cold=True)
        for key in rows:
            rows[key]["wall_ms"] = self.wall_ms(fns[key][""])
        self.kernels["integral_image"]["batched"] = {
            k: {f: r[f] for f in ("shape", "ms", "cold_ms", "slabs_ms", "plain_ms", "library_ms", "library_cold_ms",
                                  "bound_ms", "bound_by", "max_abs_err") if f in r} for k, r in rows.items()}
        return rows

    def track(self):
        """Phase w: tracking, videostab and superres at VGA on the card: the
        batched integral checks; every method of entry.track_x on
        entry.tracking_scene(), entry.stabilize_clip on entry.shaky_clip()
        and entry.superres_clip(), each counted (TRACK_LAUNCHES,
        STAB_LAUNCHES, SUPERRES_LAUNCHES, no other kernel of ours), rerun
        bit-equal, timed (ms a frame), its host syncs and peak memory; one
        profiler window over all of them; the Siamese training twice on the
        card (equal bits?); the JAX tests' gates at VGA (tracking_gates,
        stab_gates, superres_gates); the port's CPU run of every path,
        made in a process of its own while the card runs, against the
        card's on the same draws (`_draws_on_cpu`, `track_diff`)."""
        from opencv_contrib_tpu_torch.tracking import siam

        torch, entry = self.torch, self.entry
        check(tuple(entry.TRACKING) == TRACK_METHODS, f"entry.TRACKING {tuple(entry.TRACKING)} != TRACK_METHODS")
        t_all = time.perf_counter()
        parts = {}
        if getattr(self, "track_pool", None) is None:
            self.track_cpu_start()
        parts["cpu_started_s_before"] = t_all - self.track_cpu_t0
        try:
            t0 = time.perf_counter()
            batched = self.integral_batched()
            parts["integral_batched"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            scene = entry.tracking_scene(*TRACK_SHAPE, TRACK_FRAMES)
            on_card = scene._replace(**{k: self.card(v) for k, v in scene._asdict().items()
                                        if isinstance(v, np.ndarray) and v.dtype.kind == "f"
                                        and k not in entry.TRACK_HOST_FIELDS})
            clip = entry.shaky_clip(*TRACK_SHAPE, STAB_FRAMES)
            clip_card = clip._replace(frames=self.card(clip.frames))
            calls = {f"track_{m}": (lambda m=m: entry.track_x(on_card, m, device=self.dev)) for m in TRACK_METHODS}
            calls["stabilize_clip"] = lambda: entry.stabilize_clip(clip_card, device=self.dev)
            calls["superres_clip"] = lambda: entry.superres_clip(device=self.dev)
            expect = {**{f"track_{m}": TRACK_LAUNCHES.get(m, {}) for m in TRACK_METHODS},
                      "stabilize_clip": STAB_LAUNCHES, "superres_clip": SUPERRES_LAUNCHES}
            frames = {**{f"track_{m}": TRACK_STEPS for m in TRACK_METHODS}, "track_dsst": 11,
                      "track_csrt_scale": 19, "track_kcf_scale": 19, "track_kalman": 30, "track_ukf": 60,
                      "track_aukf": 30, "track_twist": 1, "stabilize_clip": STAB_FRAMES, "superres_clip": 1}
            parts["scene"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, siam_train_s = self.wall_s(lambda: entry.siam_model(self.dev))  # trained before the paths run
            parts["siam_train"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            runs, outs = {}, {}
            for path in W_PATHS:  # the first call: counted, its syncs logged, its peak
                with self.sync_log() as got:
                    (out, s1), peak = self.peak_gb(lambda: self.counted(path, calls[path]))
                launches = {k: v for k, v in self.launches[path].items() if v}
                check(launches == expect[path], f"{path}: kernel launches {launches}, expected {expect[path]}")
                syncs = self.sync_summary(got)
                outs[path] = out
                runs[path] = {"ms_first": s1 * 1e3, "frames": frames[path], "peak_mem_gb": peak,
                              "host_syncs": syncs["total"], "host_syncs_in_port": syncs["in_the_port"],
                              "sync_sites": syncs["top_sites"], "kernel_launches": launches}
            parts["card_runs"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for path in W_PATHS:  # the second call: its bits and its ms on the host clock
                again, s2 = self.wall_s(calls[path])
                runs[path].update(ms=s2 * 1e3, ms_a_frame=s2 * 1e3 / frames[path],
                                  rerun_bit_equal=_geo_equal(outs[path], again))
            parts["reruns"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            # device ms and launches from one window over the paths on the clips' first frames (W_PROFILE_FRAMES)
            cut_scene = on_card._replace(**{k: getattr(on_card, k)[:W_PROFILE_FRAMES["track"]]
                                            for k in ("frames", "centers", "siam_centers", "boxes")})
            n_stab = W_PROFILE_FRAMES["stabilize_clip"]
            cut_clip = clip_card._replace(frames=clip_card.frames[:n_stab], warps=clip.warps[:n_stab],
                                          motions=clip.motions[:n_stab - 1])
            cut_calls = {f"track_{m}": (lambda m=m: entry.track_x(cut_scene, m, device=self.dev))
                         for m in TRACK_METHODS}
            cut_calls["stabilize_clip"] = lambda: entry.stabilize_clip(cut_clip, device=self.dev)
            cut_calls["superres_clip"] = calls["superres_clip"]
            cut_frames = {p: (W_PROFILE_FRAMES["track"] - 1 if p in W_CUT_PATHS else frames[p]) for p in W_PATHS}
            cut_frames["stabilize_clip"] = n_stab
            prof = self.ximg_profile(cut_calls)
            parts["profile_split"] = self.profile_split
            for path, row in prof.items():
                top = sorted(row["kernels"].items(), key=lambda kv: -kv[1][1])[:3]
                runs[path].update(window_frames=cut_frames[path], device_ms_window=row["device_ms"],
                                  device_launches_window=row["launches"],
                                  device_ms_a_frame=row["device_ms"] / cut_frames[path],
                                  device_launches_a_frame=row["launches"] / cut_frames[path],
                                  costliest={k[:60]: [n, ms] for k, (n, ms) in top})
            parts["profile"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            retrained, train_s = self.wall_s(lambda: siam.train_siam(**entry.SIAM_TRAIN, device=self.dev))
            first = entry.siam_model(self.dev)
            train_equal = all(torch.equal(a, b) for a, b in zip(first.state_dict().values(),
                                                               retrained.state_dict().values()))
            parts["siam_retrain"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            gates, gates_missed = {}, []
            for name, fn in (("tracking", lambda: tracking_gates(scene, {m: outs[f"track_{m}"] for m in TRACK_METHODS})),
                             ("videostab", lambda: stab_gates(clip, outs["stabilize_clip"])),
                             ("superres", lambda: superres_gates(outs["superres_clip"]))):
                try:
                    gates[name] = fn()
                except AssertionError as e:  # reported with the phase's readings, then raised
                    gates_missed.append(str(e))
            parts["gates"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            same_draws = {}
            with _draws_on_cpu():  # the paths that draw, again on the CPU run's draws
                for path in ("track_tld", "track_mil", "track_boosting"):
                    same_draws[path] = _geo_host(calls[path]())
                # the stabilizer draws only in its RANSAC part: that part again, the rest from the first call
                Mr, inl = entry.stab_ransac(clip_card, self.dev)
                same_draws["stabilize_clip"] = {**_geo_host(outs["stabilize_clip"]), "ransac": _geo_host(Mr),
                                                "ransac_inliers": _geo_host(inl)}
            for seed in BOOST_SEEDS:
                with _draws_on_cpu(seed):
                    same_draws[f"track_boosting@{seed}"] = _geo_host(calls["track_boosting"]())
            parts["same_draws"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            host = self.track_cpu_job.get(timeout=900)
            parts["cpu_wait"] = time.perf_counter() - t0
            parts["cpu_run"] = host.pop("cpu_run_s")
        finally:
            if getattr(self, "x_cpu_job", None) is None:  # phase x's CPU run, queued behind this one, ends it
                self.close()
        cpu, beyond = {}, {}
        for path in W_PATHS + tuple(f"track_boosting@{seed}" for seed in BOOST_SEEDS):
            cpu[path] = track_diff(same_draws.get(path, _geo_host(outs.get(path))), host[path], path.split("@")[0])
            if not cpu[path]["ok"]:
                beyond[path] = cpu[path]
        not_equal = sorted(p for p, r in runs.items() if not r["rerun_bit_equal"])
        ok = not beyond and not not_equal and not gates_missed
        emit({"phase": "w_tracking", "ok": ok, "card_vs_cpu_beyond_tolerance": beyond,
              "rerun_not_bit_equal": not_equal, "gates_missed": gates_missed, "frame": list(TRACK_SHAPE),
              "frames": TRACK_FRAMES, "integral_batched": batched, "paths": runs, "gates": gates,
              "siam_train_s": siam_train_s, "siam_retrain_s": train_s, "siam_retrain_bit_equal": train_equal,
              "card_vs_cpu": cpu,
              "phase_parts_s": parts, "phase_s": time.perf_counter() - t_all,
              "tolerance": f"launches: {expect} a call, no other kernel of ours; every path bit-equal on a rerun; "
                           f"gates: the JAX tests' at VGA (tracking_gates, stab_gates, superres_gates); card vs "
                           f"CPU: {TRACK_CPU_TOL} (track_diff; TLD, MIL, Boosting and RANSAC on one CPU "
                           f"generator's draws, Boosting also on those of seeds {BOOST_SEEDS}); batched integral: "
                           f"bit-equal on integer patches to the plain version, to the slab kernel on the batch and "
                           f"to single slab launches, 2e-6 of the largest entry on float patches",
              "timing": "two calls a path: the first counted, its host syncs logged and its peak memory (above "
                        "what was held) read (ms_first, host clock); the second gives the rerun's bits and ms (host "
                        "clock around the synchronised call); ms_a_frame: ms over the path's frames (steps); "
                        "device_ms_a_frame and device_launches_a_frame: one profiler window (device activity only, "
                        "raw kineto events) over every path on the clips' first frames (W_PROFILE_FRAMES: "
                        f"{W_PROFILE_FRAMES}; window_frames steps; the paths that step no clip frame run whole); "
                        "the Siamese backbone trained before the "
                        "paths (siam_train_s) and again to compare bits; the CPU run went on in a process of its "
                        f"own ({TRACK_CPU_THREADS} threads, niceness 10; cpu_run: its seconds), started "
                        "cpu_started_s_before the phase (main() starts it before phase u), while these ran"})
        check(ok, f"tracking: card vs CPU beyond tolerance {beyond}, reruns not bit-equal {not_equal}, gates "
                  f"{gates_missed}")

    # ---- (x) -----------------------------------------------------------------
    def integral_channels(self) -> dict:
        """The integral kernel on WaldBoost's 8-channel VGA stack
        (INTEGRAL_CHANNELS, the slab kernel: a table is far over one block's
        48 KB) of phase x's detection frame (`x_scene`): one launch a call;
        bit-equal to 8 single launches on integer and on float channels, and
        to the plain version on integer channels 0..X_EXACT_LEVELS (tables
        below 2**24); on the frame's channels within phase c's 2e-6 of the
        largest entry of the plain version. Timed L2-warm and L2-cold beside
        the plain version and two cumsums over the batch (the library's
        call), INTEGRAL_REPS calls each in one profiler window."""
        import torch.nn.functional as F

        from opencv_contrib_tpu_torch.ops.cuda import scan
        from opencv_contrib_tpu_torch.xobjdetect import waldboost

        torch = self.torch
        N, H, W = INTEGRAL_CHANNELS
        check(not scan.one_block(H, W), f"{N}x{H}x{W}: expected the slab kernel")
        chans = waldboost.icf_channels(self.card(self.x_scene.wb_frame))
        check(tuple(chans.shape) == INTEGRAL_CHANNELS, f"ICF stack {tuple(chans.shape)}")
        ints = self.card(np.round(self.gen.uniform(0, X_EXACT_LEVELS, size=INTEGRAL_CHANNELS)))
        for kind, x in (("integer", ints), ("channels", chans)):
            out, ref = scan.integral_padded(x), scan.integral_padded_plain(x)
            singles = torch.stack([scan.integral_padded(x[i]) for i in range(N)])
            torch.cuda.synchronize()
            err, top = float((out - ref).abs().max()), float(ref.abs().max())
            check(err <= (0.0 if kind == "integer" else 2e-6 * top) and torch.equal(out, singles)
                  and torch.equal(scan.integral_padded(x), out),
                  f"integral {N}x{H}x{W} ({kind}): max err {err} (max {top}); 8 single launches and a rerun equal")
        fns = {"": lambda: scan.integral_padded(chans), "plain_": lambda: scan.integral_padded_plain(chans),
               "library_": lambda: F.pad(torch.cumsum(torch.cumsum(chans, 1), 2), (1, 0, 1, 0))}
        for fn in fns.values():  # warm
            fn()
        prof = self.ximg_profile({p: (lambda fn=fn: [fn() for _ in range(INTEGRAL_REPS)]) for p, fn in fns.items()})
        r = prof[""]
        check(r["launches"] == INTEGRAL_REPS and all(is_ours(k, "integral_kernel") for k in r["kernels"]),
              f"integral {N}x{H}x{W}: {r['launches']} launches of {list(r['kernels'])} in {INTEGRAL_REPS} calls")
        row = {"shape": list(INTEGRAL_CHANNELS), "max_abs_err": err, "max_abs": top, "integer_exact": True,
               "equal_to_single_launches": True, "launches_per_call": r["launches"] / INTEGRAL_REPS,
               **{p + "ms": prof[p]["device_ms"] / INTEGRAL_REPS for p in fns},
               "bound_ms": 4 * N * (H * W + (H + 1) * (W + 1)) / self.bw * 1e3, "bound_by": "bytes"}
        for p in ("", "library_"):
            row[p + "cold_ms"] = self.device_ms(fns[p], iters=30, cold=True)
        row["wall_ms"] = self.wall_ms(fns[""])
        self.kernels["integral_image"]["channels"] = {k: row[k] for k in (
            "shape", "ms", "cold_ms", "plain_ms", "library_ms", "library_cold_ms", "bound_ms", "bound_by",
            "max_abs_err")}
        return row

    def detection(self):
        """Phase x: background subtraction and the retina, detection, shape
        and face at VGA on the card: the integral kernel on WaldBoost's
        channel stack (`integral_channels`); every method of
        entry.background_x on entry.background_clip() and of entry.detect_x
        on entry.detection_scene(), each counted (X_LAUNCHES: the integral
        kernel once a WaldBoost detection, three times a transient step, no
        other kernel of ours), rerun bit-equal, timed (ms a frame), its host
        syncs and peak memory; one profiler window over all of them; the JAX
        tests' gates at VGA (background_gates, detection_gates); the port's
        CPU run of every method, made in a process of its own while the
        card ran earlier phases, against the card's (x_diff, X_CPU_TOL),
        GSOC and LSBP on one CPU generator's draws (`_x_draws_on_cpu`); the
        detection scene is that run's (its models trained once)."""
        torch, entry = self.torch, self.entry
        check(tuple(entry.BACKGROUND) == BG_METHODS and tuple(entry.DETECTION) == DET_METHODS,
              f"entry.BACKGROUND / DETECTION {tuple(entry.BACKGROUND)} {tuple(entry.DETECTION)}")
        t_all = time.perf_counter()
        parts = {}
        if getattr(self, "x_cpu_job", None) is None:
            self.track_cpu_start()
        try:
            t0 = time.perf_counter()
            host = self.x_cpu_job.get(timeout=600)
            parts["cpu_wait"] = time.perf_counter() - t0
            parts["cpu_run"] = host.pop("cpu_run_s")
            t0 = time.perf_counter()
            clip, scene = entry.background_clip(*X_SHAPE), host.pop("scene")
            self.x_scene = scene
            clip_card = clip._replace(**{k: self.card(v) for k, v in clip._asdict().items() if v.dtype.kind == "f"})
            scene_card = scene._replace(**{k: self.card(v) for k, v in scene._asdict().items()
                                           if isinstance(v, np.ndarray) and v.dtype.kind == "f"
                                           and k not in entry.DETECT_HOST_FIELDS})
            parts["scenes"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            channels = self.integral_channels()
            parts["integral_channels"] = time.perf_counter() - t0
            calls = {f"bg_{m}": (lambda m=m: entry.background_x(clip_card, m, device=self.dev)) for m in BG_METHODS}
            calls.update({f"det_{m}": (lambda m=m: entry.detect_x(scene_card, m, device=self.dev))
                          for m in DET_METHODS})
            frames = {**{f"bg_{m}": entry.BACKGROUND_FRAMES[m] for m in BG_METHODS},
                      **{f"det_{m}": 1 for m in DET_METHODS}}
            t0 = time.perf_counter()
            runs, outs = {}, {}
            for path in X_PATHS:  # the first call: counted, its syncs logged, its peak
                with self.sync_log() as got:
                    (out, s1), peak = self.peak_gb(lambda: self.counted(path, calls[path]))
                launches = {k: v for k, v in self.launches[path].items() if v}
                check(launches == X_LAUNCHES.get(path, {}),
                      f"{path}: kernel launches {launches}, expected {X_LAUNCHES.get(path, {})}")
                syncs = self.sync_summary(got)
                outs[path] = out
                runs[path] = {"ms_first": s1 * 1e3, "frames": frames[path], "peak_mem_gb": peak,
                              "host_syncs": syncs["total"], "host_syncs_in_port": syncs["in_the_port"],
                              "sync_sites": syncs["top_sites"], "kernel_launches": launches}
            parts["card_runs"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for path in X_PATHS:  # the second call: its bits and its ms on the host clock
                again, s2 = self.wall_s(calls[path])
                runs[path].update(ms=s2 * 1e3, ms_a_frame=s2 * 1e3 / frames[path],
                                  rerun_bit_equal=_geo_equal(outs[path], again))
            parts["reruns"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            prof = self.ximg_profile(calls)
            parts["profile_split"] = self.profile_split
            for path, row in prof.items():
                top = sorted(row["kernels"].items(), key=lambda kv: -kv[1][1])[:3]
                runs[path].update(device_ms=row["device_ms"], device_launches=row["launches"],
                                  device_ms_a_frame=row["device_ms"] / frames[path],
                                  costliest={k[:60]: [n, ms] for k, (n, ms) in top})
            parts["profile"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            gates, gates_missed = {}, []
            for name, fn in (("background", lambda: background_gates(clip, {m: outs[f"bg_{m}"] for m in BG_METHODS})),
                             ("detection", lambda: detection_gates(scene, {m: outs[f"det_{m}"] for m in DET_METHODS}))):
                try:
                    gates[name] = fn()
                except AssertionError as e:  # reported with the phase's readings, then raised
                    gates_missed.append(str(e))
            parts["gates"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            same_draws = {}
            with _x_draws_on_cpu():  # GSOC and LSBP again, on the CPU run's draws
                for m in ("gsoc", "lsbp"):
                    same_draws[f"bg_{m}"] = _geo_host(calls[f"bg_{m}"]())
            parts["same_draws"] = time.perf_counter() - t0
        finally:
            if getattr(self, "y_cpu_job", None) is None:  # phase y's CPU run, queued behind, keeps the pool
                self.close()
        cpu, beyond = {}, {}
        for path in X_PATHS:
            cpu[path] = x_diff(same_draws.get(path, _geo_host(outs[path])), host[path], path)
            if not cpu[path]["ok"]:
                beyond[path] = cpu[path]
        not_equal = sorted(p for p, r in runs.items() if not r["rerun_bit_equal"])
        ok = not beyond and not not_equal and not gates_missed
        emit({"phase": "x_detection", "ok": ok, "card_vs_cpu_beyond_tolerance": beyond,
              "rerun_not_bit_equal": not_equal, "gates_missed": gates_missed, "frame": list(X_SHAPE),
              "integral_channels": channels, "paths": runs, "gates": gates, "card_vs_cpu": cpu,
              "phase_parts_s": parts, "phase_s": time.perf_counter() - t_all,
              "tolerance": f"launches: {X_LAUNCHES} a call, no other kernel of ours; every path bit-equal on a "
                           f"rerun; gates: the JAX tests' at VGA (background_gates, detection_gates); card vs CPU: "
                           f"{X_CPU_TOL} (x_diff; GSOC and LSBP on one CPU generator's draws; the subspaces' "
                           f"columns aligned in sign first); the channel integral: one launch, bit-equal to 8 single "
                           f"launches, to the plain version on integer channels, 2e-6 of the largest entry on the "
                           f"frame's channels",
              "timing": "two calls a path: the first counted, its host syncs logged and its peak memory (above "
                        "what was held) read (ms_first, host clock); the second gives the rerun's bits and ms (host "
                        "clock around the synchronised call); ms_a_frame: ms over the path's frames (steps; a "
                        "detect_x call is one); device_ms and device_launches: one profiler window (device activity "
                        "only, raw kineto events) over a third call of every path; the CPU run went on in a "
                        f"process of its own ({X_CPU_THREADS} threads, niceness 10; cpu_run: its seconds) from "
                        "before phase u, behind phase w's, and made the detection scene (cpu_wait: the phase "
                        "waited for it first)"})
        check(ok, f"detection: card vs CPU beyond tolerance {beyond}, reruns not bit-equal {not_equal}, gates "
                  f"{gates_missed}")

    # ---- (y) -----------------------------------------------------------------
    def recognition(self):
        """Phase y: perceptual hashes and saliency, lines with multi-index
        hashing, the colour chart, the ER filter and OCR, and QR at VGA on
        the card: every method of entry.recognize_x on
        entry.recognition_scene(), each counted (Y_LAUNCHES: the integral
        kernel once a fine-grained or BING call, no other kernel of ours),
        rerun bit-equal, timed, its host syncs and peak memory; one profiler
        window over all of them; the JAX tests' gates at VGA
        (recognition_gates); the port's CPU run of every method, made in a
        process of its own behind phases w's and x's while the card ran
        earlier phases, against the card's (y_diff, Y_CPU_TOL, the hash bits
        near their thresholds counted); fine-grained saliency of an integer
        frame (0..X_EXACT_LEVELS) bit-equal to the CPU's. The scene is the
        CPU run's."""
        torch, entry = self.torch, self.entry
        from opencv_contrib_tpu_torch import saliency

        check(tuple(entry.RECOGNITION) == Y_METHODS, f"entry.RECOGNITION {tuple(entry.RECOGNITION)}")
        t_all = time.perf_counter()
        parts = {}
        if getattr(self, "y_cpu_job", None) is None:  # run alone: phase y's CPU run by itself
            import multiprocessing

            self.track_pool = multiprocessing.get_context("spawn").Pool(1, initializer=os.nice, initargs=(10,))
            self.y_cpu_job = self.track_pool.apply_async(y_cpu_outputs, (Y_SHAPE, Y_CPU_THREADS))
        try:
            t0 = time.perf_counter()
            host = self.y_cpu_job.get(timeout=600)
            parts["cpu_wait"] = time.perf_counter() - t0
            parts["cpu_run"] = host.pop("cpu_run_s")
        finally:
            if not getattr(self, "z_queued", False):  # phase z's CPU run goes in the same process
                self.close()
        t0 = time.perf_counter()
        scene = host.pop("scene")
        ints = self.card(host.pop("fine_int_frame"))
        fine_int_cpu = host.pop("fine_int_sal")
        fields = {k: (torch.from_numpy(v).to(self.dev) if v.dtype == np.int32 else self.card(v))
                  for k, v in scene._asdict().items() if v.dtype.kind == "f" or k in ("mih_codes", "mih_queries")}
        scene_card = scene._replace(**fields)
        parts["scene"] = time.perf_counter() - t0
        calls = {f"rec_{m}": (lambda m=m: entry.recognize_x(scene_card, m, device=self.dev)) for m in Y_METHODS}
        t0 = time.perf_counter()
        runs, outs = {}, {}
        for path in Y_PATHS:  # the first call: counted, its syncs logged, its peak
            with self.sync_log() as got:
                (out, s1), peak = self.peak_gb(lambda: self.counted(path, calls[path]))
            launches = {k: v for k, v in self.launches[path].items() if v}
            check(launches == Y_LAUNCHES.get(path, {}),
                  f"{path}: kernel launches {launches}, expected {Y_LAUNCHES.get(path, {})}")
            syncs = self.sync_summary(got)
            outs[path] = out
            runs[path] = {"ms_first": s1 * 1e3, "peak_mem_gb": peak, "host_syncs": syncs["total"],
                          "host_syncs_in_port": syncs["in_the_port"], "sync_sites": syncs["top_sites"],
                          "kernel_launches": launches}
        parts["card_runs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for path in Y_PATHS:  # the second call: its bits and its ms on the host clock
            again, s2 = self.wall_s(calls[path])
            runs[path].update(ms=s2 * 1e3, rerun_bit_equal=_geo_equal(outs[path], again))
        parts["reruns"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prof = self.ximg_profile(calls)
        parts["profile_split"] = self.profile_split
        for path, row in prof.items():
            top = sorted(row["kernels"].items(), key=lambda kv: -kv[1][1])[:3]
            runs[path].update(device_ms=row["device_ms"], device_launches=row["launches"],
                              costliest={k[:60]: [n, ms] for k, (n, ms) in top})
        parts["profile"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fine_int = saliency.fine_grained(ints).cpu().numpy()
        fine_int_equal = bool(np.array_equal(fine_int, fine_int_cpu))
        gates, gates_missed = {}, []
        try:
            gates = recognition_gates(scene, {m: outs[f"rec_{m}"] for m in Y_METHODS})
        except AssertionError as e:  # reported with the phase's readings, then raised
            gates_missed.append(str(e))
        cpu, beyond, near = {}, {}, 0
        for path in Y_PATHS:
            cpu[path] = y_diff(_geo_host(outs[path]), host[path], path, scene)
            near += cpu[path]["hash_bits_near_threshold"]
            if not cpu[path]["ok"]:
                beyond[path] = cpu[path]
        parts["checks"] = time.perf_counter() - t0
        not_equal = sorted(p for p, r in runs.items() if not r["rerun_bit_equal"])
        ok = not beyond and not not_equal and not gates_missed and fine_int_equal
        emit({"phase": "y_recognition", "ok": ok, "card_vs_cpu_beyond_tolerance": beyond,
              "rerun_not_bit_equal": not_equal, "gates_missed": gates_missed, "frame": list(Y_SHAPE),
              "fine_grained_integer_frame_bit_equal": fine_int_equal, "hash_bits_near_threshold": near,
              "paths": runs, "gates": gates, "card_vs_cpu": cpu, "phase_parts_s": parts,
              "phase_s": time.perf_counter() - t_all,
              "tolerance": f"launches: {Y_LAUNCHES} a call, no other kernel of ours; every path bit-equal on a "
                           f"rerun; gates: the JAX tests' at VGA (recognition_gates); card vs CPU: {Y_CPU_TOL} "
                           f"(y_diff: floats relative to the CPU value's largest magnitude; masks, integers, boxes, "
                           f"codes, MIH indices and strings equal; a hash bit may differ within hash_bit of its "
                           f"threshold, hash_margins); fine-grained saliency of an integer frame 0..{X_EXACT_LEVELS} "
                           f"bit-equal to the CPU's",
              "timing": "two calls a path: the first counted, its host syncs logged and its peak memory (above "
                        "what was held) read (ms_first, host clock); the second gives the rerun's bits and ms (host "
                        "clock around the synchronised call); device_ms and device_launches: one profiler window "
                        "(device activity only, raw kineto events) over a third call of every path; the CPU run went "
                        f"on in a process of its own ({Y_CPU_THREADS} threads, niceness 10; cpu_run: its seconds) "
                        "from before phase u, behind phases w's and x's, and made the scene (cpu_wait: the phase "
                        "waited for it first)"})
        check(ok, f"recognition: card vs CPU beyond tolerance {beyond}, reruns not bit-equal {not_equal}, gates "
                  f"{gates_missed}, integer-frame fine-grained bit-equal {fine_int_equal}")

    # ---- (z) -----------------------------------------------------------------
    def learned(self):
        """Phase z: the learned models trained in the repo, and signal, fuzzy,
        alphamat and plot, on the card. Each entry.train_learned recipe (the
        JAX test's data draws and step count, flax's initialisers from a CPU
        generator), counted (Z_LAUNCHES: the SR evaluations' quality kernels),
        timed, its host syncs; the JAX tests' gates on their readings
        (learned_gates, objdetect_gates) and an ESPCN npz round trip; every
        method of entry.learned_x on entry.learned_scene() at VGA with the
        trained models (EDSR, LapSRN x4 and the VGA SqueezeDet from flax's
        initialisers), counted, rerun bit-equal, timed, host syncs, peak
        memory, one profiler window; numeric_gates on those results and
        fixture_gates on the tests' own fixtures; the port's CPU run of every
        method at Z_CPU_SHAPE with the card's weights, in the spawned process
        behind phase y's, against the card's at that shape (z_diff,
        Z_CPU_TOL)."""
        import tempfile

        torch, entry = self.torch, self.entry
        check(tuple(entry.LEARNED) == Z_TRAIN and tuple(entry.LEARNED_METHODS) == Z_METHODS,
              f"entry.LEARNED / LEARNED_METHODS {tuple(entry.LEARNED)} {tuple(entry.LEARNED_METHODS)}")
        t_all = time.perf_counter()
        parts, train, trained, batches = {}, {}, {}, {}
        try:
            if getattr(self, "z_data_job", None) is not None:  # the QR recipes' draws, made in the spawned process
                t0 = time.perf_counter()
                batches = self.z_data_job.get(timeout=600)
                parts["data_wait"] = time.perf_counter() - t0
            for name in Z_TRAIN:
                path = f"train_{name}"
                kw = {"batches": batches[name]} if name in batches else {}
                with self.sync_log() as got:
                    res, s = self.counted(path, lambda name=name, kw=kw: entry.train_learned(name, device=self.dev,
                                                                                             **kw))
                launches = {k: v for k, v in self.launches[path].items() if v}
                check(launches == Z_LAUNCHES.get(path, {}),
                      f"{path}: kernel launches {launches}, expected {Z_LAUNCHES.get(path, {})}")
                syncs = self.sync_summary(got)
                trained[name] = res.pop("model")
                train[name] = {**res, "s": s, "ms_a_step": s * 1e3 / res["steps"], "host_syncs": syncs["total"],
                               "host_syncs_in_port": syncs["in_the_port"], "sync_sites": syncs["top_sites"],
                               "kernel_launches": launches}
                parts[path] = s
            t0 = time.perf_counter()
            models = entry.learned_models({k: trained[k] for k in ("espcn", "fsrcnn", "lapsrn", "crnn",
                                                                   "qr_detector", "qr_sr")}, device=self.dev)
            pool = getattr(self, "track_pool", None)
            if pool is None:  # run alone: phase z's CPU run by itself
                import multiprocessing

                pool = self.track_pool = multiprocessing.get_context("spawn").Pool(1, initializer=os.nice,
                                                                                   initargs=(10,))
            cpu_job = pool.apply_async(z_cpu_outputs, (z_states(models), Z_CPU_SHAPE, Z_CPU_THREADS))
            with tempfile.TemporaryDirectory() as tmp:  # test_save_load_roundtrip on the trained ESPCN
                from opencv_contrib_tpu_torch.models import DnnSuperRes

                probe = np.random.default_rng(0).uniform(size=(16, 16)).astype(np.float32)
                trained["espcn"].save_model(os.path.join(tmp, "espcn.npz"))
                back = DnnSuperRes("espcn", 2, seed=99, device=self.dev).read_model(os.path.join(tmp, "espcn.npz"))
                roundtrip = float((trained["espcn"].upsample(probe) - back.upsample(probe)).abs().max())
            scene = entry.learned_scene(*Z_SHAPE)
            small = entry.learned_scene(*Z_CPU_SHAPE)
            parts["models_and_scenes"] = time.perf_counter() - t0
            calls = {f"learn_{m}": (lambda m=m: entry.learned_x(m, models, scene, device=self.dev)) for m in Z_METHODS}
            t0 = time.perf_counter()
            runs, outs = {}, {}
            for path in Z_PATHS:  # the first call: counted, its syncs logged, its peak
                with self.sync_log() as got:
                    (out, s1), peak = self.peak_gb(lambda: self.counted(path, calls[path]))
                launches = {k: v for k, v in self.launches[path].items() if v}
                check(launches == Z_LAUNCHES.get(path, {}),
                      f"{path}: kernel launches {launches}, expected {Z_LAUNCHES.get(path, {})}")
                syncs = self.sync_summary(got)
                outs[path] = out
                runs[path] = {"ms_first": s1 * 1e3, "peak_mem_gb": peak, "host_syncs": syncs["total"],
                              "host_syncs_in_port": syncs["in_the_port"], "sync_sites": syncs["top_sites"],
                              "kernel_launches": launches}
            parts["card_runs"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for path in Z_PATHS:  # the second call: its bits and its ms on the host clock
                again, s2 = self.wall_s(calls[path])
                runs[path].update(ms=s2 * 1e3, rerun_bit_equal=_geo_equal(outs[path], again))
            parts["reruns"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            prof = self.ximg_profile(calls)
            parts["profile_split"] = self.profile_split
            for path, row in prof.items():
                top = sorted(row["kernels"].items(), key=lambda kv: -kv[1][1])[:3]
                runs[path].update(device_ms=row["device_ms"], device_launches=row["launches"],
                                  costliest={k[:60]: [n, ms] for k, (n, ms) in top})
            parts["profile"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            gates, gates_missed = {"espcn_roundtrip_max_abs": roundtrip}, []
            if roundtrip > 1e-6:
                gates_missed.append(f"espcn save/load round trip {roundtrip} > 1e-6")
            by_method = {m: outs[f"learn_{m}"] for m in Z_METHODS}
            for name, fn in (("learned", lambda: learned_gates(train, by_method, scene)),
                             ("numeric", lambda: numeric_gates(scene, by_method)),
                             ("fixtures", lambda: fixture_gates(self.dev)),
                             ("objdetect", lambda: objdetect_gates(self.dev))):
                try:
                    gates[name] = fn()
                except AssertionError as e:  # reported with the phase's readings, then raised
                    gates_missed.append(str(e))
            card_small = {f"learn_{m}": _geo_host(entry.learned_x(m, models, small, device=self.dev))
                          for m in Z_METHODS}
            parts["gates_and_small"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            host = cpu_job.get(timeout=600)
            parts["cpu_wait"] = time.perf_counter() - t0
            parts["cpu_run"] = host.pop("cpu_run_s")
        finally:
            self.close()
        cpu, beyond = {}, {}
        for path in Z_PATHS:
            cpu[path] = z_diff(card_small[path], host[path], path)
            if not cpu[path]["ok"]:
                beyond[path] = cpu[path]
        not_equal = sorted(p for p, r in runs.items() if not r["rerun_bit_equal"])
        ok = not beyond and not not_equal and not gates_missed
        emit({"phase": "z_learned", "ok": ok, "card_vs_cpu_beyond_tolerance": beyond,
              "rerun_not_bit_equal": not_equal, "gates_missed": gates_missed, "frame": list(Z_SHAPE),
              "cpu_frame": list(Z_CPU_SHAPE), "training": train, "paths": runs, "gates": gates, "card_vs_cpu": cpu,
              "kernels_at_the_evaluation_frame": {k: self.kernels[k].get("learned") for k in ("grid_transform",
                                                                                                  "grid_reduce")
                                                  if k in self.kernels},
              "phase_parts_s": parts, "phase_s": time.perf_counter() - t_all,
              "tolerance": f"launches: {Z_LAUNCHES}, no other kernel of ours on any path or recipe; every path "
                           f"bit-equal on a rerun; gates: the JAX tests' (learned_gates on the recipes' readings and "
                           f"the learned QR scenes; numeric_gates at VGA; fixture_gates and objdetect_gates on the "
                           f"tests' own fixtures); the ESPCN npz round trip within 1e-6; card vs CPU at "
                           f"{Z_CPU_SHAPE}: {Z_CPU_TOL} (z_diff)",
              "timing": "training: host clock around each synchronised recipe (s, ms_a_step), its host syncs logged; "
                        "paths: two calls each, the first counted, its host syncs logged and its peak memory (above "
                        "what was held) read (ms_first), the second gives the rerun's bits and ms (host clock around "
                        "the synchronised call); device_ms and device_launches: one profiler window (device activity "
                        "only, raw kineto events) over a third call of every path; the CPU run went on in the spawned "
                        f"process ({Z_CPU_THREADS} threads, niceness 10; cpu_run: its seconds) behind phase y's"})
        check(ok, f"learned: card vs CPU beyond tolerance {beyond}, reruns not bit-equal {not_equal}, gates "
                  f"{gates_missed}")

    def z_kernel_rows(self) -> dict:
        """grid_transform's SSIM map and grid_reduce's MSE sum at phase z's SR
        evaluation frame (Z_SHAPE), against their plain versions, timed warm
        and cold beside the library call, with their bounds; phase k runs it
        (its ten profiler windows took 27.9 s at the end of the whole script
        on the H100 and 0.7-1.0 s in phase z alone) and adds the rows to the
        kernels line's under "learned"."""
        import torch.nn.functional as F

        from opencv_contrib_tpu_torch.ops.cuda import reduce as kr
        from opencv_contrib_tpu_torch.ops.cuda import transform as tf

        H, W = Z_SHAPE
        n = H * W
        u = [self.card(self.gen.uniform(0, 1, size=(H, W))) for _ in range(2)]
        var = self.card(self.gen.uniform(0.01, 0.05, size=(H, W)))
        xs = [u[0], u[1], u[0] * u[0] + var, u[1] * u[1] + var, u[0] * u[1]]
        m = tf.ssim(1e-4, 9e-4)
        err = self.ulp_check(tf.grid_transform(m, *xs), tf.grid_transform_plain(m.fn, *xs), "grid_transform ssim (z)")
        rows = {"grid_transform": self.row(
            "grid_transform", (H, W), err, {"": lambda: tf.grid_transform(m, *xs),
                                            "plain_": lambda: tf.grid_transform_plain(m.fn, *xs),
                                            "library_": lambda: m.fn(*xs)},
            4 * (m.n_in + 1) * n, 22 * n, TRANSFORM_KERNELS, cold=True, map="ssim")}
        sq = tf.sqdiff()
        out, ref = kr.grid_reduce(sq, u[0], u[1]), kr.grid_reduce_plain(sq.fn, u[0], u[1])
        err = abs(float(out) - float(ref))
        check(err <= 1e-5 * float(ref), f"grid_reduce sqdiff (z): err {err}")
        rows["grid_reduce"] = self.row(
            "grid_reduce", (H, W), err, {"": lambda: kr.grid_reduce(sq, u[0], u[1]),
                                         "plain_": lambda: kr.grid_reduce_plain(sq.fn, u[0], u[1]),
                                         "library_": lambda: F.mse_loss(u[0], u[1], reduction="sum")},
            4 * 2 * n + 4, 3 * n, REDUCE_KERNELS, cold=True, map="sqdiff", kind="sum")
        for k, row in rows.items():
            if k in self.kernels:
                self.kernels[k]["learned"] = row
        return rows

    def kernels_line(self):
        line = []
        for name, row in self.kernels.items():
            path = LAUNCH_PATH[name]
            src, rep = SOURCES[name]
            line.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                         "launches": self.launches[path][name], "launches_path": path, "shape": row["shape"],
                         "max_abs_err": row["max_abs_err"], "ms": row["ms"], "kernel_ms": row.get("kernel_ms", row["ms"]),
                         "launches_by_path": {p: self.launches[p][name] for p, ks in PATH_KERNELS.items()
                                              if name in ks and p in self.launches},
                         "plain_ms": row["plain_ms"],
                         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                         "library_ms": row["library_ms"], "wall_ms": row["wall_ms"],
                         **{k: row[k] for k in ("cold_ms", "library_cold_ms", "bound_over_cold_ms", "frame_ms",
                                                "frame_library_ms", "widths", "batched", "channels", "learned")
                            if k in row}})
        emit({"kernels": line})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU", file=sys.stderr)
        return 2
    smoke = Smoke()
    try:
        for phase in (smoke.build, smoke.knn2, smoke.scan, smoke.frontend, smoke.tick, smoke.profile,
                      smoke.reduce_vec, smoke.kinfu, smoke.profile_kinfu, smoke.pyrdown_remap, smoke.dense_flow,
                      smoke.grid_kernels, smoke.photometric, smoke.sfm, smoke.sparse_ba, smoke.sfm_scale, smoke.rgbd,
                      smoke.remainder, smoke.distributed, smoke.xfeatures, smoke.video, smoke.track_cpu_start,
                      smoke.ximgproc, smoke.geometry, smoke.track, smoke.detection,
                      smoke.recognition, smoke.learned):
            phase()
    finally:
        smoke.close()
    emit({"windows_retaken": len(smoke.retaken), "their_readings": smoke.retaken[:20]})
    smoke.kernels_line()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": smoke.name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
