"""Top-level entry points of the port.

- `frontend(img1, img2)`: the two-frame feature frontend (Fast-Hessian
  detect, SURF describe, ratio-test match), the twin of
  `__graft_entry__.entry`.
- `keyframe_tick(imgs, intr)`: the SfM keyframe tick of `bench.py`'s
  `bench_keyframes`: the frontend on every frame, match to the previous
  frame, DLT + Gauss-Newton resection, then one bundle-adjustment refresh
  over a 16-camera x 2048-point synthetic problem.
- `kinfu_track(depths, intr, ...)`: the KinectFusion tick over a depth
  sequence (`bench.py::bench_kinfu_vga512` runs it at VGA / 512^3 on the
  frames of `kinfu_bench_frames`).

They run on the card unless the caller passes `device="cpu"`; with no card
they raise. Matrix products run in full f32 inside them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.ba import bundle
from opencv_contrib_tpu_torch.core import camera as cam
from opencv_contrib_tpu_torch.features import describe, detect, match
from opencv_contrib_tpu_torch.mvg import resection
from opencv_contrib_tpu_torch.rgbd import kinfu
from opencv_contrib_tpu_torch.rgbd.tsdf import TSDFVolume
from opencv_contrib_tpu_torch.utils.device import resolve
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls
from opencv_contrib_tpu_torch.utils.synthetic import generate_scene


def _f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


@f32_matmuls
def frontend(img1, img2, K: int = 128, threshold: float = 40.0, ratio: float = 0.9, device="cuda"):
    """Detect K keypoints in each frame, describe them, and match frame 1
    against frame 2 with the cross-checked ratio test. Returns (match count,
    train_idx (K,), distance (K,))."""
    dev = resolve(device)
    img1, img2 = _f32(img1, dev), _f32(img2, dev)
    k1 = detect.fast_hessian(img1, max_keypoints=K, threshold=threshold)
    k2 = detect.fast_hessian(img2, max_keypoints=K, threshold=threshold)
    d1 = describe.surf_describe(img1, k1)
    d2 = describe.surf_describe(img2, k2)
    m = match.ratio_test_match(d1, d2, k1.valid, k2.valid, ratio=ratio)
    return m.valid.sum(), m.train_idx, m.distance


def make_frames(n_frames: int = 32, H: int = 480, W: int = 640, seed: int = 0) -> np.ndarray:
    """Smooth random texture shifted 3 px per frame (a plane scene with
    constant flow): (n_frames + 1, H, W) float32 on 0..255, as bench.py
    builds its keyframe sequence."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (H, W)).astype(np.float32)
    for ax in (0, 1):
        base = (base + np.roll(base, 1, ax) + np.roll(base, 2, ax) + np.roll(base, 4, ax)) / 4.0
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    return np.stack([np.roll(base, 3 * i, axis=1) for i in range(n_frames + 1)]).astype(np.float32)


def ba_problem(n_views: int = 16, n_points: int = 2048, seed: int = 0, device="cpu") -> bundle.BAProblem:
    """The keyframe tick's BA refresh problem: a synthetic scene with its
    points perturbed by N(0, 0.02) noise drawn from `seed`."""
    scene = generate_scene(n_views=n_views, n_points=n_points, seed=seed)
    rng = np.random.default_rng(seed)
    noisy = scene.points3d + rng.normal(scale=0.02, size=(n_points, 3)).astype(np.float32)
    return bundle.make_problem_from_scene(scene.Rs, scene.ts, noisy, scene.intr,
                                          scene.points2d, scene.visible, device=device)


class KeyframeTick(NamedTuple):
    ts: torch.Tensor  # (N, 3) per-frame translation of the resected pose
    n_ok: torch.Tensor  # (N,) matches used for each resection
    ba: bundle.BAResult


@f32_matmuls
def track_frames(imgs: torch.Tensor, intr: torch.Tensor, K: int = 512):
    """The per-frame half of the tick on imgs (N+1, H, W): returns (ts, n_ok)."""

    def fe(img):
        k = detect.fast_hessian(img, max_keypoints=K, threshold=20.0)
        return describe.surf_describe(img, k), k.valid, torch.stack([k.x, k.y], dim=1)

    def lift(xy):  # back-project at unit depth
        xn = cam.normalize_points(intr, xy)
        return torch.cat([xn, torch.ones_like(xn[:, :1])], dim=1)

    prev_d, prev_v, xy = fe(imgs[0])
    prev_xyz = lift(xy)
    ts, n_ok = [], []
    for img in imgs[1:]:
        d, v, xy = fe(img)
        m = match.ratio_test_match(prev_d, d, prev_v, v, ratio=0.85)
        xn = cam.normalize_points(intr, xy[m.train_idx.long()])
        ok = m.valid & prev_v
        R0, t0 = resection.pnp_dlt(prev_xyz, xn, mask=ok)
        _, t, _ = resection.refine_pose(R0, t0, prev_xyz, xn, ok, iters=5)
        ts.append(t)
        n_ok.append(ok.sum())
        prev_d, prev_v, prev_xyz = d, v, lift(xy)
    return torch.stack(ts), torch.stack(n_ok)


def keyframe_tick(imgs, intr, K: int = 512, n_ba: int = 10, ba_views: int = 16,
                  ba_points: int = 2048, device="cuda") -> KeyframeTick:
    """Track imgs (N+1, H, W) frame to frame, then run `n_ba` LM iterations
    of bundle adjustment over a `ba_views` x `ba_points` problem."""
    dev = resolve(device)
    ts, n_ok = track_frames(_f32(imgs, dev), _f32(intr, dev), K)
    res = bundle.bundle_adjust(ba_problem(ba_views, ba_points, device=dev), n_iters=n_ba)
    return KeyframeTick(ts, n_ok, res)


class KinFuTrack(NamedTuple):
    T_cw: torch.Tensor  # (N, 4, 4) world -> camera pose after each frame
    ok: torch.Tensor  # (N,) tracking flag of each frame (True for the first)
    volume: TSDFVolume  # the volume after the last frame


def kinfu_track(depths, intr, frame_shape=(480, 640), volume_resolution=(512, 512, 512), volume_size: float = 3.0,
                volume_center=(0.0, 0.0, 2.0), sparse_blocks: int | None = 12288, device="cuda") -> KinFuTrack:
    """Run the KinFu tick over depths (N, H, W) in meters: per-frame pose
    and tracking flag, and the final volume. The defaults are the VGA /
    512^3 configuration of `bench.py::bench_kinfu_vga512`. Nothing is read
    back to the host until the caller reads the result."""
    p = kinfu.KinFuParams(intr=np.asarray(intr, np.float32), frame_shape=tuple(frame_shape),
                          volume_resolution=tuple(volume_resolution), volume_size=volume_size,
                          volume_center=tuple(volume_center), sparse_blocks=sparse_blocks)
    kf = kinfu.KinFu(p, device=device)
    poses, oks = [], []
    for d in depths:
        kf.update(d, sync=False)
        poses.append(kf.T_cw)
        oks.append(kf.last_ok)
    return KinFuTrack(torch.stack(poses), torch.stack(oks), kf.volume)


def kinfu_bench_frames(n: int, H: int = 480, W: int = 640) -> np.ndarray:
    """The depth ramp of `bench.py::bench_kinfu_vga512` (`base + 0.002 * i`
    for frame i, in meters): (n, H, W) float32."""
    base = (2.0 + 0.3 * np.sin(np.linspace(0, 6, W))[None, :]
            + 0.2 * np.cos(np.linspace(0, 4, H))[:, None]).astype(np.float32)
    return np.stack([base + 0.002 * i for i in range(n)])
