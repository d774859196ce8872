"""Distributed SfM building blocks composed — the port of
opencv_contrib_tpu/parallel/dist_sfm.py: the BASELINE "distributed SfM"
configuration (5k images over N hosts) in miniature.

A pipeline step, each stage on the devices of the mesh:
  1. the feature frontend over the dp axis (each dp rank detects and
     describes its block of frames, then an all-gather);
  2. ring all-pairs matching over the sp axis (descriptor blocks travel the
     ring);
  3. Schur BA with the observation grid sharded over (dp, sp).

The host only sequences stages, the split the single-host pipeline uses.
"""

from __future__ import annotations

import time

import torch
from torch.distributed.device_mesh import DeviceMesh

from opencv_contrib_tpu_torch.ba import bundle
from opencv_contrib_tpu_torch.parallel import dist_ba, ring_match
from opencv_contrib_tpu_torch.parallel.mesh import all_gather, axis_index, check_divisible, mesh_device
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


@f32_matmuls
def batched_frontend(imgs, mesh: DeviceMesh, max_keypoints: int = 256, threshold: float = 10.0):
    """Detect + describe a batch of frames sharded over dp.

    imgs (N, H, W) with N divisible by the dp size, the same on every rank.
    Returns (descs (N, K, D), xy (N, K, 2), valid (N, K)) on every rank.
    """
    from opencv_contrib_tpu_torch.features import describe, detect

    n_local = check_divisible(len(imgs), mesh, "dp", "frames")
    d = axis_index(mesh, "dp")
    mine = torch.as_tensor(imgs[d * n_local:(d + 1) * n_local]).to(mesh_device(mesh), torch.float32)  # one copy
    descs, xys, valids = [], [], []
    for img in mine:
        k = detect.fast_hessian(img, max_keypoints=max_keypoints, threshold=threshold, n_octaves=2)
        descs.append(describe.surf_describe(img, k))
        xys.append(k.xy())
        valids.append(k.valid.to(torch.uint8))
    return (all_gather(torch.stack(descs), mesh, "dp"), all_gather(torch.stack(xys), mesh, "dp"),
            all_gather(torch.stack(valids), mesh, "dp").to(torch.bool))


def distributed_matching(descs, valids, mesh: DeviceMesh, ratio: float = 0.8):
    """Ring all-pairs matching (descriptor blocks over sp)."""
    return ring_match.ring_all_pairs_match(descs, valids, mesh, ratio=ratio)


def distributed_bundle(problem: bundle.BAProblem, mesh: DeviceMesh, **kw) -> bundle.BAResult:
    return dist_ba.bundle_adjust(problem, mesh, **kw)


def _time(f) -> float:
    t0 = time.perf_counter()
    f()
    return time.perf_counter() - t0


def scaling_report(problem: bundle.BAProblem, mesh: DeviceMesh, n_iters: int = 10, repeats: int = 3):
    """Timing comparison single-device vs sharded BA — the scaling-efficiency
    measurement harness (BASELINE: >= 0.7 efficiency 1 host -> N). Host
    clock around each solve, with the device synchronised after it."""
    sync = torch.cuda.synchronize if mesh.device_type == "cuda" else (lambda: None)

    def run_single():
        bundle.bundle_adjust(problem, n_iters=n_iters)
        sync()

    def run_sharded():
        dist_ba.bundle_adjust(problem, mesh, n_iters=n_iters)
        sync()

    run_single()
    run_sharded()  # warm both
    t_s = min(_time(run_single) for _ in range(repeats))
    t_d = min(_time(run_sharded) for _ in range(repeats))
    n_dev = mesh.size()
    return {"t_single_s": t_s, "t_sharded_s": t_d, "n_devices": int(n_dev), "speedup": t_s / t_d,
            "efficiency": (t_s / t_d) / n_dev}
