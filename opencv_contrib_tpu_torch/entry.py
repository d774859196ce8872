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
- `hash_kinfu_track(depths, intr, ...)`: the same on the hashed-block
  volume (`rgbd.kinfu.HashKinFu`), at VGA and 3 m / 512 voxels by default.
- `large_kinfu_track(depths, intr, ...)`: the submap-based large-scale KinFu
  (`rgbd.submap.LargeKinFu`); the tracker is returned for loop constraints
  and its pose-graph optimisation.
- `rgbd_odometry(gray_src, depth_src, gray_dst, depth_dst, intr, method)`:
  frame-to-frame RGB-D odometry (`rgbd.odometry.compute`: "rgbd", "icp" or
  "merged").
- `tum_kinfu(root)`: a TUM RGB-D sequence on disk through the port's loader
  (`utils.native.TumLoader`, its own PNG codec), KinFu on each depth, and
  the ATE against the sequence's groundtruth.txt, read back from disk.
- `dynafu_track(depths, intr)`: DynaFu (`rgbd.dynafu.DynaFu`), non-rigid
  fusion through a warp field, over a depth sequence.
- `dense_flow(I0, I1, method)`: dense optical flow by DIS, TV-L1, DeepFlow,
  SimpleFlow, sparse-to-dense, dense RLOF or PCAFlow; `flow_pair()` makes a
  textured pair at MPI-Sintel's 436 x 1024 with its true flow.
- `photometric(degraded, clean)`: the photometric / image-quality path over
  an RGB clip (gamma, grayworld white balance, gray, CLAHE, then PSNR,
  SSIM, GMSD, BRISQUE features and the no-reference score against the
  clean clip); `photo_clip()` makes a full-HD clip and its degraded copy.
- `video_photometric(path, clean)`: the same path on a clip read from disk
  through `utils.video.VideoReader` (Y4M or MJPG AVI, onto the card), with
  `xphoto.dct_denoise` between gray and CLAHE and the trained BRISQUE score
  of every frame; `video_clip(dir, codec)` writes `photo_clip()`'s
  degraded clip as such a file.
- `features_x(img1, img2, detector, descriptor)`: the xfeatures2d breadth
  on a frame pair: detect with any of the port's detectors, describe with
  any of its descriptors (float ones matched by squared L2, binary ones by
  Hamming) and match with the cross-checked ratio test; `feature_pair()`
  makes a textured VGA frame, the frame rotated by 15 degrees about its
  centre, and the map between them.
- `ximgproc_frame(img, method)`: one image-structure method (ximgproc, HFS,
  SWT: edge-aware smoothing of images and disparity, superpixels,
  segmentations and proposals, the learned edge map, lines, circles,
  ellipses, MSER, text boxes) on a frame, with the settings of the JAX test
  that gates it (`METHODS`); `structure_frame()` makes a VGA frame holding
  those tests' fixtures, with a disparity pair.
- `geometry_x(scene, method)`: one geometry / calibration method beside
  the SfM stack (stereo BM / SGM / quasi-dense and the left-right check,
  Gray code, PSP, FTP, FAPS and the DCT unwrap, reg's five models, ArUco /
  ChArUco, the random-pattern corner finder, omnidir calibration and
  undistortion, RAPID, PPF with ICP, cloud ICP) with the settings of the
  JAX test that gates it (`GEOMETRY`); `geometry_scene()` makes those
  tests' fixtures at VGA, each with its ground truth.
- `track_x(scene, method)`: one tracker or filter of the tracking module
  (MOSSE, KCF, CSRT, DSST, the scaled CSRT / KCF, the Kalman filters,
  MedianFlow, TLD, MIL, Boosting, the MultiTracker, TrackerByMatching, the
  twist, the Siamese tracker trained in the repo) with the settings of the
  JAX test that gates it (`TRACKING`); `tracking_scene()` makes a VGA clip
  holding each of those tests' own fixtures.
- `stabilize_clip(clip)`: the videostab path (stabilize, RANSAC motion,
  the L1 path, deblurring, both inpainters, wobble suppression) on
  `shaky_clip()`'s frames; `superres_clip()`: BTV super-resolution of 4
  low-res frames with known and with DIS flows.
- `background_x(clip, method)` and `detect_x(scene, method)`: background
  subtraction and the retina; detection, shape and face.
- `recognize_x(scene, method)`: one perceptual hash, saliency map (spectral
  residual, fine-grained, BING, motion), line detector with LBD and
  multi-index hashing, the colour chart and its CCM, the ER filter, an OCR
  decoder or the QR decoder, with the settings of the JAX test that gates
  it (`RECOGNITION`); `recognition_scene()` lays those tests' fixtures
  into VGA frames, with MIH at a matcher's size.
- `sfm.pipeline.reconstruct_incremental(tracks, intr)`: the incremental SfM
  driver; `sfm_scene()` makes its 100-view x 900-track synthetic scene.
- `sfm.pipeline_scale.reconstruct_sequential(tracks, intr)`: the sequential
  SfM driver at the 5k-view scale (sparse slot tracks, windowed and global
  sparse BA); `sfm_sequence_scene()` makes its 5,000-view x 1,024-slot
  orbit.
- `dryrun_multichip(n_devices)`: the distributed layer (`parallel/`) over an
  n_devices mesh: sharded dense and sparse BA, the ring match and the
  sequential driver's mesh route, the twin of
  `__graft_entry__.dryrun_multichip`.

They run on the card unless the caller passes `device="cpu"`; with no card
they raise. Matrix products run in full f32 inside them.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch import (aruco, ccalib, hfs, phase_unwrapping, quality, rapid, reg, stereo,  # noqa: I001
                                      structured_light, surface_matching, ximgproc, xphoto)
from opencv_contrib_tpu_torch.aruco import charuco
from opencv_contrib_tpu_torch.ba import bundle
from opencv_contrib_tpu_torch.ccalib import omnidir
from opencv_contrib_tpu_torch.core import camera as cam
from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.core.color import rgb_to_gray
from opencv_contrib_tpu_torch.features import describe, describe_x, detect, detect_x, learned, match
from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.flow import dis, extra, pcaflow, tvl1
from opencv_contrib_tpu_torch.intensity_transform import gamma_correction
from opencv_contrib_tpu_torch.mvg import resection
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.histogram import clahe
from opencv_contrib_tpu_torch.ops.image import warp_affine
from opencv_contrib_tpu_torch.quality import brisque_svr
from opencv_contrib_tpu_torch.rgbd import kinfu, odometry, submap
from opencv_contrib_tpu_torch.rgbd.dynafu import DynaFu
from opencv_contrib_tpu_torch.rgbd.hash_tsdf import HashTSDF
from opencv_contrib_tpu_torch.rgbd.tsdf import TSDFVolume
from opencv_contrib_tpu_torch.sfm.pipeline_scale import SparseTracks, from_sequence_scene, reconstruct_sequential
from opencv_contrib_tpu_torch.sfm.tracks import TracksTensor
from opencv_contrib_tpu_torch.structured_light import sinusoidal
from opencv_contrib_tpu_torch.utils import datasets, metrics, native, video
from opencv_contrib_tpu_torch.utils.device import constant, resolve, to_device
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls
from opencv_contrib_tpu_torch.utils.synthetic import SequenceScene, generate_scene, generate_sequence_scene
from opencv_contrib_tpu_torch.text import swt
from opencv_contrib_tpu_torch.ximgproc import edge_forest, hough_mser


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


class HashKinFuTrack(NamedTuple):
    T_cw: torch.Tensor  # (N, 4, 4) world -> camera pose after each frame
    ok: torch.Tensor  # (N,) tracking flag of each frame (True for the first)
    n_active: torch.Tensor  # (N,) allocated blocks after each frame
    volume: HashTSDF  # the volume after the last frame


def hash_kinfu_track(depths, intr, frame_shape=(480, 640), voxel_size: float = 3.0 / 512, capacity: int = 16384,
                     device="cuda") -> HashKinFuTrack:
    """Run the hashed-block KinFu tick (`rgbd.kinfu.HashKinFu`) over depths
    (N, H, W) in meters: per-frame pose, tracking flag and block count, and
    the final volume. Nothing is read back to the host until the caller
    reads the result."""
    p = kinfu.KinFuParams(intr=np.asarray(intr, np.float32), frame_shape=tuple(frame_shape),
                          volume_resolution=(512, 512, 512), volume_size=voxel_size * 512)
    kf = kinfu.HashKinFu(p, capacity=capacity, device=device)
    poses, oks, active = [], [], []
    for d in depths:
        kf.update(d, sync=False)
        poses.append(kf.T_cw)
        oks.append(kf.last_ok)
        active.append(kf.volume.active.sum())
    return HashKinFuTrack(torch.stack(poses), torch.stack(oks), torch.stack(active), kf.volume)


class LargeKinFuTrack(NamedTuple):
    T_cw: torch.Tensor  # (N, 4, 4) world -> camera pose after each frame
    ok: list  # tracking flag of each frame (True for the first)
    n_submaps: list  # submaps after each frame
    tracker: submap.LargeKinFu  # for add_loop_constraint / optimize_pose_graph


def large_kinfu_track(depths, intr, frame_shape=(480, 640), device="cuda", **params) -> LargeKinFuTrack:
    """Run the large-scale KinFu (`rgbd.submap.LargeKinFu`) over depths
    (N, H, W) in meters; `params` are further `LargeKinFuParams` fields
    (volume_resolution, max_dist_from_center, ...). The tracker reads two
    values back to the host a frame (the reference's control flow)."""
    p = submap.LargeKinFuParams(intr=np.asarray(intr, np.float32), frame_shape=tuple(frame_shape), **params)
    lk = submap.LargeKinFu(p, device=device)
    poses, oks, counts = [], [], []
    for d in depths:
        oks.append(lk.update(d))
        poses.append(lk.T_cw)
        counts.append(len(lk.submaps))
    return LargeKinFuTrack(torch.stack(poses), oks, counts, lk)


def rgbd_odometry(gray_src, depth_src, gray_dst, depth_dst, intr, method: str = "merged", device="cuda"):
    """The transform src camera -> dst camera from two gray + depth frames
    (`rgbd.odometry.compute`): (T (4, 4) on the device, success bool)."""
    return odometry.compute(gray_src, depth_src, gray_dst, depth_dst, intr, method=method, device=device)


class TumKinFu(NamedTuple):
    poses: np.ndarray  # (N, 4, 4) camera -> world pose after each frame (KinFu's world: the first camera)
    ate: float  # ATE RMSE (m) of the tracked frames against groundtruth.txt, similarity-aligned
    frames: int  # frames the loader gave
    lost: list  # indices of the frames whose tracking failed (left out of the ATE)


def tum_kinfu(root, intr=None, frame_shape=None, device="cuda", n_threads: int = 4, prefetch: int = 8,
              **params) -> TumKinFu:
    """A TUM RGB-D sequence from disk through KinFu (tests/test_tum_e2e.py's
    harness): `utils.native.TumLoader` decodes the frames (n_threads workers,
    prefetch frames ahead), `rgbd.kinfu.KinFu` tracks each depth, and the
    trajectory's ATE (`utils.metrics.ate_rmse`) is taken against the
    ground-truth pose nearest each frame's rgb timestamp
    (`datasets.tum_gt_pose_at` on groundtruth.txt). intr defaults to
    `datasets.TUM_FR1_INTR`, frame_shape to the frames' size; `params` are
    further `KinFuParams` fields (volume_resolution, volume_size,
    volume_center, sparse_blocks, ...). The ticks run unsynchronised; the
    tracking flags and poses are read back once, after the last frame."""
    dev = resolve(device)
    loader = native.TumLoader(str(root), n_threads=n_threads, prefetch=prefetch)
    intr = datasets.TUM_FR1_INTR if intr is None else np.asarray(intr, np.float32)
    shape = (loader.height, loader.width) if frame_shape is None else tuple(frame_shape)
    kf = kinfu.KinFu(kinfu.KinFuParams(intr=intr, frame_shape=shape, **params), device=dev)
    T_cw, oks, stamps = [], [], []
    with loader:
        for t_rgb, _, _, depth in loader:
            kf.update(depth, sync=False)
            T_cw.append(kf.T_cw)
            oks.append(kf.last_ok)
            stamps.append(t_rgb)
    poses = se3.inverse(torch.stack(T_cw)).cpu().numpy()
    ok = torch.stack(oks).cpu().numpy()
    gt = datasets.load_tum(str(root)).gt
    if gt is None:
        raise FileNotFoundError(f"{root}: no groundtruth.txt")
    traj_gt = np.stack([datasets.tum_gt_pose_at(gt, t)[:3, 3] for t in stamps])
    ate = metrics.ate_rmse(poses[ok, :3, 3], traj_gt[ok])
    return TumKinFu(poses, float(ate), len(stamps), [int(i) for i in np.flatnonzero(~ok)])


class DynaFuTrack(NamedTuple):
    ok: list  # tracking flag of each frame (True for the first)
    tracker: DynaFu  # its volume, warp field, get_cloud and render_live


def dynafu_track(depths, intr, device="cuda", **params) -> DynaFuTrack:
    """Run DynaFu (`rgbd.dynafu.DynaFu`) over depths (N, H, W) in meters;
    `params` are its constructor's (volume_resolution, volume_size,
    volume_center, n_nodes, node_sigma; frame_shape defaults to the frames'
    size). Each frame reads its tracking flag back to the host."""
    if "frame_shape" not in params:
        params["frame_shape"] = tuple(depths[0].shape)
    df = DynaFu(intr, device=device, **params)
    return DynaFuTrack([df.update(d) for d in depths], df)


def kinfu_bench_frames(n: int, H: int = 480, W: int = 640) -> np.ndarray:
    """The depth ramp of `bench.py::bench_kinfu_vga512` (`base + 0.002 * i`
    for frame i, in meters): (n, H, W) float32."""
    base = (2.0 + 0.3 * np.sin(np.linspace(0, 6, W))[None, :]
            + 0.2 * np.cos(np.linspace(0, 4, H))[:, None]).astype(np.float32)
    return np.stack([base + 0.002 * i for i in range(n)])


FLOW_METHODS = {"dis": dis.compute, "tvl1": tvl1.compute, "deepflow": extra.deepflow, "simpleflow": extra.simpleflow,
                "sparse_to_dense": extra.sparse_to_dense, "rlof": extra.rlof_dense, "pcaflow": pcaflow.compute}


@f32_matmuls
def dense_flow(I0, I1, method: str = "dis", device="cuda", **params) -> torch.Tensor:
    """Dense flow I0 -> I1 of two (H, W) frames: (H, W, 2) as (dy, dx), on
    `device`. `method`: "dis" (`flow.dis.compute`), "tvl1"
    (`flow.tvl1.compute`), "deepflow", "simpleflow", "sparse_to_dense",
    "rlof" (`flow.extra.deepflow`, `simpleflow`, `sparse_to_dense`,
    `rlof_dense`) or "pcaflow" (`flow.pcaflow.compute`); `params` go to it
    (levels, ...)."""
    if method not in FLOW_METHODS:
        raise ValueError(f"dense_flow: method must be one of {sorted(FLOW_METHODS)}, got {method!r}")
    dev = resolve(device)
    return FLOW_METHODS[method](_f32(I0, dev), _f32(I1, dev), **params)


def flow_pair(H: int = 436, W: int = 1024, seed: int = 3, angle: float = 0.01, shift_xy=(3.0, -5.0)):
    """A textured frame pair with known flow, at MPI-Sintel's frame size by
    default: I0 is seeded uniform noise blurred by a Gaussian of sigma 1.5,
    times 4 (`tests/test_flow.py`'s texture); I1 = warp_affine(I0, M) with M
    (output -> input) a rotation by `angle` about the center plus the shift
    (x, y). Returns (I0, I1, flow) as float32 numpy arrays, flow (H, W, 2)
    (dy, dx) = M^-1 p - p."""
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.uniform(0, 1, size=(H, W)).astype(np.float32))
    I0 = filters.gaussian_blur(noise, 1.5) * 4.0
    c, s = np.cos(angle), np.sin(angle)
    cy, cx = H / 2, W / 2
    M = np.array([[c, -s, cx - c * cx + s * cy + shift_xy[0]],
                  [s, c, cy - s * cx - c * cy + shift_xy[1]]], np.float32)
    I1 = warp_affine(I0, torch.from_numpy(M))
    Mh = np.eye(3, dtype=np.float32)
    Mh[:2] = M
    Minv = np.linalg.inv(Mh)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    gx = Minv[0, 0] * x + Minv[0, 1] * y + Minv[0, 2] - x
    gy = Minv[1, 0] * x + Minv[1, 1] * y + Minv[1, 2] - y
    return I0.numpy(), I1.numpy(), np.stack([gy, gx], axis=-1).astype(np.float32)


def _blur_np(x: np.ndarray, sigma: float, axis: int) -> np.ndarray:
    """Gaussian blur along one axis with wrapped borders, in numpy."""
    r = int(np.ceil(3.0 * sigma))
    k = np.exp(-np.arange(-r, r + 1) ** 2 / (2.0 * sigma * sigma)).astype(np.float32)
    k /= k.sum()
    out = np.zeros_like(x)
    for i, w in enumerate(k):
        out += w * np.roll(x, i - r, axis=axis)
    return out


def photo_clip(T: int = 8, H: int = 1080, W: int = 1920, seed: int = 0):
    """A textured RGB clip and its degraded copy, float32 (T, H, W, 3) in
    [0, 1], numpy only. `clean`: seeded uniform noise blurred by a Gaussian
    of sigma 2 (wrapped borders), stretched to [0, 1], shifted 4 px to the
    right per frame. `degraded`: clean ** 2.2 (darkened), times the colour
    cast (1.25, 1.0, 0.75), plus N(0, 0.01) seeded noise, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    base = rng.random((H, W, 3), dtype=np.float32)
    base = _blur_np(_blur_np(base, 2.0, 0), 2.0, 1)
    base = (base - base.min()) / (base.max() - base.min())
    clean = np.stack([np.roll(base, 4 * t, axis=1) for t in range(T)])
    degraded = clean ** np.float32(2.2) * np.array([1.25, 1.0, 0.75], np.float32)
    degraded += np.float32(0.01) * rng.standard_normal(degraded.shape, dtype=np.float32)
    return clean, np.clip(degraded, 0.0, 1.0, out=degraded)


class Photometric(NamedTuple):
    balanced: torch.Tensor  # (T, H, W, 3) gamma-corrected, grayworld-balanced clip
    equalized: torch.Tensor  # (T, H, W) its gray frames after CLAHE: the conditioned clip
    psnr: list  # per frame, Python floats (dB), against the clean clip's gray frames
    ssim: torch.Tensor  # (T,)
    gmsd: torch.Tensor  # (T,)
    nr_score: torch.Tensor  # (T,) no-reference score of the equalized frame
    features: torch.Tensor  # (T, 36) BRISQUE features of the equalized frame


PHOTO_GAMMA, CLAHE_CLIP, CLAHE_GRID = 1 / 2.2, 4.0, 8  # undo photo_clip's x ** 2.2; CLAHE's defaults


@f32_matmuls
def photometric(degraded, clean, device="cuda") -> Photometric:
    """The photometric / image-quality path over an RGB clip (T, H, W, 3) in
    [0, 1]: `intensity_transform.gamma_correction` (1 / 2.2) over the whole clip, then
    for each frame `xphoto.grayworld_wb`, `core.color.rgb_to_gray`,
    `ops.histogram.clahe`, and the scores against `rgb_to_gray(clean[t])`
    (`quality.psnr`, `ssim`, `gmsd`) and of the frame alone
    (`quality.brisque_features`, `no_reference_score`)."""
    dev = resolve(device)
    deg, cln = _f32(degraded, dev), _f32(clean, dev)
    lin = gamma_correction(deg, PHOTO_GAMMA)
    bal, eq, ps, ss, gm, nr, feats = [], [], [], [], [], [], []
    for t in range(deg.shape[0]):
        wb = xphoto.grayworld_wb(lin[t])
        out = clahe(rgb_to_gray(wb), clip_limit=CLAHE_CLIP, grid=CLAHE_GRID)
        ref = rgb_to_gray(cln[t])
        bal.append(wb)
        eq.append(out)
        ps.append(quality.psnr(out, ref))
        ss.append(quality.ssim(out, ref))
        gm.append(quality.gmsd(out, ref))
        nr.append(quality.no_reference_score(out))
        feats.append(quality.brisque_features(out))
    return Photometric(torch.stack(bal), torch.stack(eq), ps, torch.stack(ss), torch.stack(gm), torch.stack(nr),
                       torch.stack(feats))


VIDEO_CODECS = {"y4m": ".y4m", "MJPG": ".avi"}
VIDEO_DENOISE_SIGMA = 0.01  # photo_clip()'s noise
_BRISQUE_MODELS: dict = {}  # device -> the default trained head, trained once


def video_clip(dir, codec: str = "y4m", T: int = 8, H: int = 1080, W: int = 1920, seed: int = 0):
    """Write `photo_clip(T, H, W, seed)`'s degraded clip into directory
    `dir` as Y4M (`codec` "y4m", I420) or MJPG AVI ("MJPG", JPEG quality 90)
    at 30 frames/s and return (its path, the clean clip)."""
    if codec not in VIDEO_CODECS:
        raise ValueError(f"video_clip: codec must be one of {sorted(VIDEO_CODECS)}, got {codec!r}")
    clean, degraded = photo_clip(T, H, W, seed)
    path = os.path.join(str(dir), f"photo_clip_{codec.lower()}{VIDEO_CODECS[codec]}")
    wtr = video.create_video_writer(path, (W, H), 30.0, codec=codec)
    for frame in degraded:
        wtr.write(frame)
    wtr.release()
    return path, clean


class VideoPhotometric(NamedTuple):
    balanced: torch.Tensor  # (T, H, W, 3) gamma-corrected, grayworld-balanced clip
    equalized: torch.Tensor  # (T, H, W) its gray frames, denoised, after CLAHE
    psnr: list  # per frame, Python floats (dB), against the clean clip's gray frames
    ssim: torch.Tensor  # (T,)
    gmsd: torch.Tensor  # (T,)
    nr_score: torch.Tensor  # (T,) no-reference score of the equalized frame
    features: torch.Tensor  # (T, 36) BRISQUE features of the equalized frame
    brisque: list  # per frame, Python floats: the trained head's score of the denoised frame, before CLAHE
    decode_ms: float  # host ms the reader spent a decoded frame


@f32_matmuls
def video_photometric(path, clean, model=None, device="cuda") -> VideoPhotometric:
    """The photometric path on a clip on disk: `utils.video.VideoReader`
    (batch 8) reads it onto the device; each batch gets
    `gamma_correction` (1 / 2.2), each frame `xphoto.grayworld_wb`,
    `rgb_to_gray`, `xphoto.dct_denoise` (sigma VIDEO_DENOISE_SIGMA),
    `clahe`, and the scores of `photometric` against `rgb_to_gray(clean[t])`.
    The trained BRISQUE score (`quality.brisque_svr`) is that of the
    denoised frame, before CLAHE: CLAHE's local contrast puts the
    equalized frame's features far outside the head's training range,
    where every RBF term underflows and the score is 0 whatever the frame.
    The model is `model`, or the default head trained once on this
    device."""
    dev = resolve(device)
    if model is None:
        model = _BRISQUE_MODELS.get(str(dev))
        if model is None:
            model = _BRISQUE_MODELS[str(dev)] = brisque_svr.train_brisque_model(device=dev)
    cln = _f32(clean, dev)
    bal, eq, ps, ss, gm, nr, feats, scores = [], [], [], [], [], [], [], []
    with video.VideoReader(str(path), batch=8, device=dev) as reader:
        for deg in reader:
            lin = gamma_correction(deg, PHOTO_GAMMA)
            for t in range(deg.shape[0]):
                wb = xphoto.grayworld_wb(lin[t])
                g = xphoto.dct_denoise(rgb_to_gray(wb), sigma=VIDEO_DENOISE_SIGMA)
                out = clahe(g, clip_limit=CLAHE_CLIP, grid=CLAHE_GRID)
                ref = rgb_to_gray(cln[len(eq)])
                bal.append(wb)
                eq.append(out)
                ps.append(quality.psnr(out, ref))
                ss.append(quality.ssim(out, ref))
                gm.append(quality.gmsd(out, ref))
                nr.append(quality.no_reference_score(out))
                feats.append(quality.brisque_features(out))
                scores.append(brisque_svr.score_features(model, quality.brisque_features(g)))
        decode_ms = reader.decode_s * 1e3 / max(reader.frames_decoded, 1)
    return VideoPhotometric(torch.stack(bal), torch.stack(eq), ps, torch.stack(ss), torch.stack(gm),
                            torch.stack(nr), torch.stack(feats), scores, decode_ms)


def feature_pair(H: int = 480, W: int = 640, angle_deg: float = 15.0, seed: int = 2):
    """A textured frame and the frame rotated by angle_deg about its centre:
    seeded uniform noise on 0..255 blurred by a Gaussian of sigma 1.5, then
    `warp_affine` (`tests/test_features_x.py::texture_pair` at any size).
    Returns (img1, img2, fwd) as float32 numpy: fwd (2, 3) maps a point
    (x, y) of img1 to img2 as fwd[:, :2] @ (x, y) + fwd[:, 2]."""
    rng = np.random.default_rng(seed)
    img = filters.fast_gaussian_blur(torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)), 1.5)
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    cx, cy = W / 2.0, H / 2.0
    M = np.array([[c, -s, cx - c * cx + s * cy], [s, c, cy - s * cx - c * cy]], np.float32)  # out -> in
    img2 = warp_affine(img, torch.from_numpy(M))
    Rm = np.array([[c, -s], [s, c]], np.float32)
    t = M[:, 2]
    fwd = np.concatenate([Rm.T, -(t @ Rm)[:, None]], axis=1).astype(np.float32)  # (xy - t) @ Rm
    return img.numpy(), img2.numpy(), fwd


# each detector and the settings features_x gives it (tests/test_features_x.py's Fast-Hessian threshold; FAST's
# threshold on 0..255 frames; Star's default of 30 finds no keypoint on feature_pair()'s texture at VGA)
DETECTORS = {"fast_hessian": (detect.fast_hessian, {"threshold": 20.0}),
             "star": (detect_x.star_detector, {"response_threshold": 10.0}),
             "msd": (detect_x.msd_detector, {}), "harris_laplace": (detect_x.harris_laplace, {}),
             "harris": (detect.harris, {}), "fast": (detect.fast_corners, {"threshold": 20.0})}
FLOAT_DESCRIPTORS = {"surf": describe.surf_describe, "daisy": describe.daisy_describe,
                     "lucid": describe_x.lucid_describe, "vgg": learned.vgg_describe}
BINARY_DESCRIPTORS = {"brief": describe.brief_describe, "boxes": describe.binary_boxes_describe,
                      "freak": lambda img, k: describe_x.freak_describe(img, k)[:2],
                      "latch": describe_x.latch_describe, "boostdesc": learned.boostdesc_describe}
RATIO = 0.95  # tests/test_features_x.py's ratio test


class FeaturesX(NamedTuple):
    k1: Keypoints
    k2: Keypoints
    d1: torch.Tensor  # (K, D) float descriptors, or +-1 signs of binary ones
    d2: torch.Tensor
    matches: match.Matches


@f32_matmuls
def features_x(img1, img2, detector: str = "fast_hessian", descriptor: str = "surf", K: int = 512,
               detector_params: dict | None = None, device="cuda") -> FeaturesX:
    """Detect up to K keypoints in each frame with `detector` (one of
    DETECTORS, with its settings there updated by detector_params;
    Fast-Hessian carries the SURF Haar orientation), describe
    them with `descriptor` (FLOAT_DESCRIPTORS, matched by squared L2, or
    BINARY_DESCRIPTORS, matched by Hamming on their +-1 signs), and match
    frame 1 against frame 2 with the cross-checked ratio test at RATIO. The
    learned descriptors take their default projections
    (`features.learned.default_projection`, trained once on the CPU)."""
    if detector not in DETECTORS:
        raise ValueError(f"features_x: detector must be one of {sorted(DETECTORS)}, got {detector!r}")
    if descriptor not in FLOAT_DESCRIPTORS and descriptor not in BINARY_DESCRIPTORS:
        raise ValueError(f"features_x: descriptor must be one of "
                         f"{sorted([*FLOAT_DESCRIPTORS, *BINARY_DESCRIPTORS])}, got {descriptor!r}")
    dev = resolve(device)
    img1, img2 = _f32(img1, dev), _f32(img2, dev)
    find, params = DETECTORS[detector]
    params = {**params, **(detector_params or {})}
    k1, k2 = (find(img, max_keypoints=K, **params) for img in (img1, img2))
    binary = descriptor in BINARY_DESCRIPTORS
    fn = (BINARY_DESCRIPTORS if binary else FLOAT_DESCRIPTORS)[descriptor]
    d1, d2 = (fn(img, k)[1] if binary else fn(img, k) for img, k in ((img1, k1), (img2, k2)))
    m = match.ratio_test_match(d1, d2, k1.valid, k2.valid, ratio=RATIO, metric="hamming" if binary else "l2")
    return FeaturesX(k1, k2, d1, d2, m)


STRUCTURE_SHAPE = (480, 640)


def structure_layout(H: int = 480, W: int = 640) -> dict:
    """Where `structure_frame` puts each element, in pixels, at any size
    (the VGA layout scaled by H / 480 and W / 640):
    - band: the row y where the dark upper band (0.1) meets the striped
      lower band (0.8), a straight step edge across the whole frame;
    - box: the bright (0.95) rectangular object [y0, x0, y1, x1], inclusive;
    - ellipse: the bright ring's (cx, cy, a, b), a along x (the JAX test's
      ring: its size and tent profile 1 - 4 |r - 1|);
    - circle: the bright (0.9) disc's (cy, cx, r) (the ED circles test's);
    - line: the bright (0.95) vertical bar [y0, x0, y1, x1] whose ends fade
      out over `fade` rows, so each of its sides is a straight edge of its
      own;
    - plate: the white text plate [y0, x0, y1, x1] in the lower band, and
      glyphs: the dark bars' (y0, y1, x0s, stroke), the JAX text test's
      'letters' (36 rows tall, 3 wide, 20 apart), their word box text;
    - empty: a patch of the upper band with no edge (the EdgeBoxes test's
      empty box).
    The ring, the disc and the glyphs keep the JAX tests' sizes, which the
    detectors' settings fix (Canny's thresholds on the ring's slope,
    hough_circles' radii 8-24, SWT's max_width)."""
    sy, sx = H / 480.0, W / 640.0
    s = min(sy, sx)
    band = int(round(300 * sy))
    glyph_x = [int(round(x * sx)) for x in (420, 440, 460, 480)]
    stroke = max(1, int(round(3 * s)))
    gy0, gy1 = int(round(360 * sy)), int(round(396 * sy))
    return {"band": band,
            "box": [int(round(60 * sy)), int(round(40 * sx)), int(round(155 * sy)), int(round(135 * sx))],
            "ellipse": (260.0 * sx, 150.0 * sy, 30.0 * s, 18.0 * s),
            "circle": (150.0 * sy, 420.0 * sx, 15.0 * s),
            "line": [int(round(40 * sy)), int(round(560 * sx)), int(round(259 * sy)), int(round(565 * sx))],
            "fade": max(2, int(round(40 * sy))),
            "plate": [int(round(330 * sy)), int(round(380 * sx)), int(round(439 * sy)), int(round(619 * sx))],
            "glyphs": (gy0, gy1, glyph_x, stroke),
            "text": [gy0, glyph_x[0], gy1 - 1, glyph_x[-1] + stroke - 1],
            "empty": [int(round(175 * sy)), int(round(40 * sx)), int(round(270 * sy)), int(round(135 * sx))]}


class StructureFrame(NamedTuple):
    rgb: np.ndarray  # (H, W, 3) float32 in [0, 1]
    disparity: np.ndarray  # (2, H, W) float32: left (holes 0) and right, positive magnitudes in pixels
    layout: dict  # structure_layout(H, W)


def structure_frame(H: int = 480, W: int = 640, seed: int = 0) -> StructureFrame:
    """An RGB frame for the image-structure path (`ximgproc_frame`), float32
    in [0, 1], with a disparity pair: the JAX tests' fixtures of
    tests/test_ximgproc*.py, tests/test_text.py and the HFS test placed in
    one VGA frame (`structure_layout` gives every element's place):
    piecewise-constant regions (a dark upper band, a bright lower band of
    0.03 stripes) with N(0, 0.01) texture, the bright rectangular object of the
    selective-search and EdgeBoxes tests, a straight band edge and a
    vertical bar with faded ends (ED lines, Hough), a disc (ED circles,
    Hough circles), the ellipse ring of the findEllipses test, and a white
    plate with the text test's four dark glyph bars. The colour is a tint
    of the gray scene (the object and the plate keep their colour's gray).

    The disparity is piecewise constant: 8 px in the upper band, 14 px on
    the object, 20 px on the disc, and 12 to 30 px down the lower band (a
    floor), the right map forward-warped from the left (nearer wins); the
    left map has 12 square holes of 0. Returns StructureFrame(rgb,
    disparity, layout), numpy."""
    L = structure_layout(H, W)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    band = L["band"]
    g = np.where(yy < band, 0.1, 0.8 + 0.03 * np.sin(2 * np.pi * xx / 6.0)).astype(np.float32)
    y0, x0, y1, x1 = L["box"]
    g[y0:y1 + 1, x0:x1 + 1] = 0.95
    cx, cy, a, b = L["ellipse"]
    ring = np.clip(1.0 - np.abs(((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 - 1.0) * 4.0, 0, 1)
    g = np.maximum(g, ring.astype(np.float32))
    ccy, ccx, r = L["circle"]
    disc = (yy - ccy) ** 2 + (xx - ccx) ** 2 <= r * r
    g[disc] = 0.9
    ly0, lx0, ly1, lx1 = L["line"]
    fade = L["fade"]
    t = np.clip(np.minimum(yy - ly0, ly1 - yy) / fade, 0.0, 1.0)
    on_bar = (xx >= lx0) & (xx <= lx1) & (yy >= ly0) & (yy <= ly1)
    g = np.where(on_bar, 0.1 + 0.85 * t, g).astype(np.float32)
    py0, px0, py1, px1 = L["plate"]
    g[py0:py1 + 1, px0:px1 + 1] = 1.0
    gy0, gy1, gxs, stroke = L["glyphs"]
    for gx in gxs:
        g[gy0:gy1, gx:gx + stroke] = 0.0
    g = np.clip(g + rng.normal(0, 0.01, g.shape).astype(np.float32), 0.0, 1.0)
    tint = np.array([1.0, 0.97, 0.9], np.float32)
    rgb = np.clip(g[..., None] * tint / np.float32(tint @ np.array([0.299, 0.587, 0.114], np.float32)), 0, 1)

    dl = np.where(yy < band, 8.0, 12.0 + 18.0 * (yy - band) / max(H - band, 1)).astype(np.float32)
    dl[y0:y1 + 1, x0:x1 + 1] = 14.0
    dl[disc] = 20.0
    dr = np.zeros_like(dl)
    for yi in range(H):  # forward warp x -> x - d, the nearer (larger d) winning
        xs = np.round(np.arange(W) - dl[yi]).astype(np.int64)
        ok = xs >= 0
        order = np.argsort(dl[yi][ok], kind="stable")
        dr[yi, xs[ok][order]] = dl[yi][ok][order]
    hs = max(2, int(round(8 * min(H / 480.0, W / 640.0))))
    for hy, hx in zip(rng.integers(0, H - hs, 12), rng.integers(0, W - hs, 12)):
        dl[hy:hy + hs, hx:hx + hs] = 0.0
    return StructureFrame(rgb.astype(np.float32), np.stack([dl, dr]), L)


class _XFrame(NamedTuple):
    """What an ximgproc_frame method reads: the frame on the device."""
    gray: torch.Tensor
    rgb: torch.Tensor
    disparity: torch.Tensor | None
    layout: dict


def _ellipse_points(layout: dict, n: int, device) -> torch.Tensor:
    cx, cy, a, b = layout["ellipse"]
    t = torch.arange(n, dtype=torch.float32, device=device) * (2 * np.pi / n)
    return torch.stack([cy + b * torch.sin(t), cx + a * torch.cos(t)], 1)  # (n, 2) y, x


def _ellipse_conic(layout: dict, device) -> torch.Tensor:
    cx, cy, a, b = layout["ellipse"]
    # (x - cx)^2 / a^2 + (y - cy)^2 / b^2 - 1 = 0
    return constant([1 / a ** 2, 0.0, 1 / b ** 2, -2 * cx / a ** 2, -2 * cy / b ** 2,
                     cx ** 2 / a ** 2 + cy ** 2 / b ** 2 - 1.0], device)


def _needs_disparity(f: _XFrame) -> torch.Tensor:
    if f.disparity is None:
        raise ValueError("ximgproc_frame: this method filters a disparity pair: pass disparity=(2, H, W)")
    return f.disparity


def _edge_box_candidates(layout: dict) -> np.ndarray:
    """The EdgeBoxes test's three boxes: tight around the object's edges,
    the layout's empty patch, strictly inside the object."""
    y0, x0, y1, x1 = layout["box"]
    h, w = y1 - y0, x1 - x0
    return np.array([[y0 - 2, x0 - 2, y1 + 2, x1 + 2], layout["empty"],
                     [y0 + h // 3, x0 + w // 3, y1 - h // 3, x1 - w // 3]])


def _color_template(f: _XFrame) -> torch.Tensor:
    """The colour-match test's template: a patch of the frame (the object's
    upper-left corner with the band around it)."""
    y0, x0, _, _ = f.layout["box"]
    h = max(4, (f.layout["box"][2] - y0) // 3)
    return f.rgb[y0 - h // 2:y0 + h // 2, x0 - h // 2:x0 + h // 2].clone()


# each method: (call on the frame, the settings of the JAX test that gates it)
METHODS = {
    "anisotropic_diffusion": (lambda f, **k: ximgproc.anisotropic_diffusion(f.gray, **k), {"n_iters": 30}),
    "rolling_guidance_filter": (lambda f, **k: ximgproc.rolling_guidance_filter(f.gray, **k),
                                {"sigma_s": 2.0, "sigma_r": 0.2}),
    "dt_filter": (lambda f, **k: ximgproc.dt_filter(f.gray, f.gray, **k), {"sigma_s": 10.0, "sigma_r": 0.15}),
    "niblack_threshold": (lambda f, **k: ximgproc.niblack_threshold(f.gray, **k), {"block_radius": 5}),
    "ridge_filter": (lambda f, **k: ximgproc.ridge_filter(f.gray, **k), {"sigma": 1.5}),
    "fast_global_smoother": (lambda f, **k: ximgproc.fast_global_smoother(f.gray, f.gray, **k),
                             {"lam": 64.0, "sigma_color": 0.1}),
    "disparity_wls_filter": (lambda f, **k: ximgproc.disparity_wls_filter(*_needs_disparity(f), f.gray, **k), {}),
    "l0_smooth": (lambda f, **k: ximgproc.l0_smooth(f.gray, **k), {"lam": 0.02}),
    "bilateral_texture_filter": (lambda f, **k: ximgproc.bilateral_texture_filter(f.gray, **k), {"fr": 2}),
    "joint_bilateral_filter": (lambda f, **k: ximgproc.joint_bilateral_filter(f.gray, f.gray, **k),
                               {"sigma_s": 2.0, "sigma_r": 0.2, "radius": 3}),
    "weighted_median_filter": (lambda f, **k: ximgproc.weighted_median_filter(f.gray, f.gray, **k),
                               {"radius": 3, "n_bins": 8}),
    "deriche_gradient_x": (lambda f, **k: ximgproc.deriche_gradient_x(f.gray, **k), {"alpha": 1.5}),
    "deriche_gradient_y": (lambda f, **k: ximgproc.deriche_gradient_y(f.gray, **k), {"alpha": 1.0}),
    "paillou_gradient_x": (lambda f, **k: ximgproc.paillou_gradient_x(f.gray, **k), {"alpha": 1.0, "omega": 0.2}),
    "paillou_gradient_y": (lambda f, **k: ximgproc.paillou_gradient_y(f.gray, **k), {"alpha": 1.0, "omega": 0.2}),
    "edge_preserving_filter": (lambda f, **k: ximgproc.edge_preserving_filter(f.gray, **k),
                               {"radius": 3, "threshold": 0.3}),
    "adaptive_manifold_filter": (lambda f, **k: ximgproc.adaptive_manifold_filter(f.gray, f.gray, **k),
                                 {"sigma_s": 8.0, "sigma_r": 0.3}),
    "fast_bilateral_solver": (lambda f, **k: ximgproc.fast_bilateral_solver(f.gray, f.gray, torch.ones_like(f.gray),
                                                                            **k), {"lam": 4.0, "radius": 2}),
    "fourier_descriptors": (lambda f, **k: ximgproc.fourier_descriptors(_ellipse_points(f.layout, 64, f.gray.device),
                                                                        **k), {}),
    "radon_transform": (lambda f, **k: ximgproc.radon_transform(f.gray, **k), {"n_angles": 24}),
    "peilin_normalization": (lambda f, **k: ximgproc.peilin_normalization(f.gray, **k), {}),
    "color_match_template": (lambda f, **k: ximgproc.color_match_template(f.rgb, _color_template(f), **k), {}),
    "covariance_estimation": (lambda f, **k: ximgproc.covariance_estimation(f.gray, **k), {"window": 5}),
    "erode_fast": (lambda f, **k: ximgproc.erode_fast(f.gray, **k), {"radius_y": 3, "radius_x": 3}),
    "dilate_fast": (lambda f, **k: ximgproc.dilate_fast(f.gray, **k), {"radius_y": 3, "radius_x": 3}),
    "scan_segment": (lambda f, **k: ximgproc.scan_segment(f.gray, **k), {"n_superpixels": 32, "n_iters": 4}),
    "find_ellipses": (lambda f, **k: ximgproc.find_ellipses(f.gray, **k), {"max_ellipses": 4, "min_pts": 20}),
    "conic_to_ellipse": (lambda f, **k: ximgproc.conic_to_ellipse(_ellipse_conic(f.layout, f.gray.device), **k), {}),
    "slic": (lambda f, **k: ximgproc.slic(f.gray, **k), {"grid": 4, "compactness": 0.5}),
    "hfs_segment": (lambda f, **k: hfs.hfs_segment(f.gray, **k), {"grid": 8, "seg_thresh1": 0.3, "seg_thresh2": 0.6}),
    "region_features": (lambda f, **k: hfs.region_features(f.gray, ximgproc.slic(f.gray, grid=8)[0], 64, **k), {}),
    "region_adjacency": (lambda f, **k: hfs.region_adjacency(f.gray, ximgproc.slic(f.gray, grid=8)[0], 64, **k), {}),
    "seeds": (lambda f, **k: ximgproc.seeds(f.gray, **k), {"grid": 8, "n_iters": 12}),
    "lsc": (lambda f, **k: ximgproc.lsc(f.gray, **k), {"grid": 8}),
    "graph_segment": (lambda f, **k: ximgproc.graph_segment(f.gray, **k), {"k": 0.5}),
    "selective_search": (lambda f, **k: ximgproc.selective_search(f.gray, **k), {"base_k": 0.5, "max_proposals": 48}),
    "edge_boxes": (lambda f, **k: ximgproc.edge_boxes(
        f.gray, _edge_box_candidates(f.layout), edge_map=edge_forest.structured_edges(f.gray), **k), {}),
    "structured_edges_lite": (lambda f, **k: ximgproc.structured_edges_lite(f.gray, **k), {}),
    "fast_hough_lines": (lambda f, **k: ximgproc.fast_hough_lines(ximgproc.canny(f.gray), **k), {}),
    "thinning": (lambda f, **k: ximgproc.thinning(f.gray > 0.85, **k), {"n_iters": 10}),
    "structured_edges": (lambda f, **k: edge_forest.structured_edges(f.gray, **k), {}),
    "edges_nms": (lambda f, **k: edge_forest.edges_nms(edge_forest.structured_edges(f.gray), f.gray, **k), {}),
    "stroke_width_map": (lambda f, **k: swt.stroke_width_map(f.gray, **k), {"max_width": 16}),
    "detect_text": (lambda f, **k: swt.detect_text(f.gray, **k), {"max_width": 16}),
    "ed_lines": (lambda f, **k: ximgproc.ed_lines(f.gray, **k), {"min_length": 20}),
    "ed_circles": (lambda f, **k: ximgproc.ed_circles(f.gray, **k), {"min_points": 16}),
    "canny": (lambda f, **k: ximgproc.canny(f.gray, **k), {}),
    "hough_circles_accumulator": (lambda f, **k: hough_mser.hough_circles_accumulator(f.gray, **k), {}),
    "hough_circles": (lambda f, **k: ximgproc.hough_circles(f.gray, **k), {}),
    "mser": (lambda f, **k: ximgproc.mser(f.gray, **k), {}),
}


@f32_matmuls
def ximgproc_frame(img, method: str, device="cuda", disparity=None):
    """One image-structure method on a frame: `method` one of METHODS, with
    its settings there (the JAX test's that gates it). img (H, W, 3) RGB in
    [0, 1] (gray by `core.color.rgb_to_gray`, one grid_transform launch) or
    (H, W) gray; disparity (2, H, W), the left and right maps, for
    "disparity_wls_filter". `structure_layout(H, W)` places the inputs that
    a method takes besides the frame: the EdgeBoxes candidates, the colour
    template, the Fourier contour and the conic. The learned edge map's model trains on
    the device on first use. Tensors stay on `device`; the methods that
    the JAX package answers in numpy (boxes, proposals, lines, circles,
    regions, segment maps) answer in numpy."""
    if method not in METHODS:
        raise ValueError(f"ximgproc_frame: method must be one of {sorted(METHODS)}, got {method!r}")
    dev = resolve(device)
    x = _f32(img, dev)
    if x.ndim == 3:
        rgb, gray = x, rgb_to_gray(x)
    else:
        rgb, gray = x[..., None].expand(*x.shape, 3), x
    H, W = gray.shape
    disp = _f32(disparity, dev) if disparity is not None else None
    fn, settings = METHODS[method]
    return fn(_XFrame(gray, rgb, disp, structure_layout(H, W)), **settings)


# ---- geometry and calibration beside the SfM stack ----------------------------------------------------------


class GeometryScene(NamedTuple):
    """The fixtures of `geometry_x` (numpy, float32 unless stated), each
    with its ground truth. H, W = left.shape.

    - Stereo (tests/test_bgsegm_stereo.py::_stereo_pair's recipe): `left`
      a Gaussian-blurred (sigma 1) uniform texture; `right` the left image
      rolled by -8 px (x_r = x_l - d), with the box's pixels pasted 24 px
      left of their place instead; `disparity` the true left disparity: 8,
      24 on `stereo_box` [y0, x0, y1, x1] (inclusive).
    - Gray code: `graycode` (40, H, W), the 10 column and 9 row bits of a
      W x H projector and their inverses, white and black, seen directly
      with a gain U(0.4, 0.8), an offset U(0, 0.2) and N(0, 0.01) noise per
      pixel: the decoded column is x and the row y at every pixel.
    - `psp` (4, H, W): 4-step fringes of 40 periods across the width; the
      wrapped phase is angle(exp(i 2 pi 40 x / W)).
    - `fringe` (3, H, W): tests/test_breadth2.py::TestSinusoidalFtpFaps'
      scene at this size (48 periods across the width, the Gaussian bump
      scaled with the frame), 3 shifts of 2 pi / 3; `fringe_true` (H, W)
      its phase: the FTP / FAPS phase is -fringe_true + a constant.
    - reg: `reg_ref` a Gaussian-blurred (sigma 2) uniform texture times 3;
      `reg_mov` (5, H, W), the reference warped by each of `reg.MODELS`'
      motions (`reg_motion`, (5, 3, 3) output -> input pixel maps): a 2, 3
      px shift, a 0.05 rad rotation about the centre with a (1.0, -1.5)
      shift (tests/test_imgproc_modules.py::TestReg), a 1.02 scale with a
      0.03 rad rotation, the JAX test's affine about the centre, and a
      projective map of the same size.
    - ArUco: `charuco` a 5 x 5 ChArUco board of `square_px` squares (80 at
      VGA, scaled with the frame) with `dictionary` (12 4-bit markers,
      uint8, the JAX test's), white around, its top-left corner at
      `board_origin` (y, x); `board_ids`, `board_centers` as
      `aruco.charuco.draw_charuco_board` returns them. The 16 interior
      corners lie on origin + square_px k; each marker faces the camera
      K = [[500, 0, W / 2], [0, 500, H / 2], [0, 0, 1]]: a marker of side
      0.06 m spans `marker_span_px` (59 at VGA) between its corner pixels,
      so R = I and t_z = 500 * 0.06 / marker_span_px.
    - ccalib: `pattern` = `ccalib.generate_pattern((H, W))` and
      `pattern_view`, it rolled by (4, 7): the view's pixels are the
      pattern's moved by (x, y) = (7, 4). `omni_obj` (6, 48, 3), the 8 x 6
      board of tests/test_breadth8.py::TestOmniCalibrate, and `omni_img`
      (6, 48, 2) its projections through `omni_K` (f = 600 W / 640, c the
      centre) and `omni_xi` 0.9 with N(0, 0.1 px) noise.
    - RAPID (tests/test_detect_breadth.py::TestRapid at 120 x 160, K and
      the search length scaled to the frame): `rapid_img` the cube's front
      face rendered at `rapid_t` with R = I through `rapid_K`; the track
      starts from `rapid_t0`; `rapid_vertices` (4, 3), `rapid_edges`
      (4, 2) int.
    - Surface matching: `cloud` (N, 3) and `cloud_normals`, the box cloud of
      tests/test_surface_matching.py with 500 points a face at VGA;
      `cloud_T_ppf` the pose of the scene PPF finds (the JAX test's) and
      `cloud_T_icp` the small misalignment of TestCloudICP."""
    left: np.ndarray
    right: np.ndarray
    disparity: np.ndarray
    stereo_box: list
    graycode: np.ndarray
    psp: np.ndarray
    fringe: np.ndarray
    fringe_true: np.ndarray
    reg_ref: np.ndarray
    reg_mov: np.ndarray
    reg_motion: np.ndarray
    charuco: np.ndarray
    square_px: int
    marker_span_px: int
    dictionary: np.ndarray
    board_origin: tuple
    board_ids: list
    board_centers: np.ndarray
    pattern: np.ndarray
    pattern_view: np.ndarray
    omni_obj: np.ndarray
    omni_img: np.ndarray
    omni_K: np.ndarray
    omni_xi: float
    rapid_img: np.ndarray
    rapid_K: np.ndarray
    rapid_t: np.ndarray
    rapid_t0: np.ndarray
    rapid_vertices: np.ndarray
    rapid_edges: np.ndarray
    cloud: np.ndarray
    cloud_normals: np.ndarray
    cloud_T_ppf: np.ndarray
    cloud_T_icp: np.ndarray


GEO_STEREO_DISP = (8, 24)  # background, box
GEO_SQUARES = (5, 5)  # the ChArUco board's squares
GEO_MARKER_M = 0.06  # the pose method's marker side in metres
GEO_FOCAL = 500.0  # the ArUco camera's focal length in pixels (at any frame size)


def _box_cloud(n_per_face: int = 36, size=(1.0, 0.6, 0.4)):
    """Points + outward normals sampled on a box surface
    (tests/test_surface_matching.py::_box_cloud)."""
    rng = np.random.default_rng(0)
    pts, nrms = [], []
    faces = [(np.array([1.0, 0, 0]), size[0] / 2), (np.array([-1.0, 0, 0]), size[0] / 2),
             (np.array([0, 1.0, 0]), size[1] / 2), (np.array([0, -1.0, 0]), size[1] / 2),
             (np.array([0, 0, 1.0]), size[2] / 2), (np.array([0, 0, -1.0]), size[2] / 2)]
    dims = np.array(size)
    for n, off in faces:
        free = np.flatnonzero(n == 0)
        for _ in range(n_per_face):
            p = n * off
            for f in free:
                p[f] = rng.uniform(-dims[f] / 2, dims[f] / 2)
            pts.append(p)
            nrms.append(n)
    return np.array(pts, np.float32), np.array(nrms, np.float32)


def _render_square(K: np.ndarray, t: np.ndarray, shape, s: float = 0.5) -> np.ndarray:
    """tests/test_detect_breadth.py::_render_wire_cube at R = I: the cube's
    front face as a bright square with analytic partial-pixel coverage, so
    the intensity step sits at the true subpixel boundary."""
    verts = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float32) + t
    uv = verts[:, :2] / verts[:, 2:] * np.diag(K)[:2] + K[:2, 2]
    y0, y1 = uv[:, 1].min(), uv[:, 1].max()
    x0, x1 = uv[:, 0].min(), uv[:, 0].max()
    ys = np.arange(shape[0])[:, None]
    xs = np.arange(shape[1])[None, :]
    cov_y = np.clip(np.minimum(y1, ys + 0.5) - np.maximum(y0, ys - 0.5), 0, 1)
    cov_x = np.clip(np.minimum(x1, xs + 0.5) - np.maximum(x0, xs - 0.5), 0, 1)
    return (cov_y * cov_x).astype(np.float32)


def _reg_motions(H: int, W: int) -> np.ndarray:
    """reg_motion: (5, 3, 3) output -> input pixel maps (x, y, 1), in
    reg.MODELS order, each about the frame's centre but the shift."""
    cy, cx = H / 2.0, W / 2.0

    def about_centre(A, t):
        c = np.array([cx, cy])
        M = np.eye(3)
        M[:2, :2] = A
        M[:2, 2] = c - A @ c + np.asarray(t)
        return M

    def rot(a, s=1.0):
        return s * np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])

    proj = about_centre(np.eye(2), (1.0, -1.0))
    proj[2, :2] = (2e-5, -1.5e-5)
    proj[2, 2] = 1.0 - proj[2, 0] * cx - proj[2, 1] * cy  # 1 at the centre
    return np.stack([about_centre(np.eye(2), (2.0, 3.0)), about_centre(rot(0.05), (1.0, -1.5)),
                     about_centre(rot(0.03, 1.02), (1.5, -1.0)),
                     about_centre(np.array([[1.03, 0.02], [-0.01, 0.97]]), (-2.0, 1.0)), proj]).astype(np.float32)


def geometry_scene(H: int = 480, W: int = 640, seed: int = 0) -> GeometryScene:
    """The fixtures of `geometry_x` at H x W: the JAX tests' fixtures of the
    stereo, structured-light, phase-unwrapping, reg, ArUco / ChArUco,
    ccalib, RAPID and surface-matching modules, brought to the frame size
    (`GeometryScene` gives each with its ground truth). The cloud has
    500 points a face at 480 rows, scaled with H (at least 36)."""
    from opencv_contrib_tpu_torch.aruco import charuco, markers
    from opencv_contrib_tpu_torch.ccalib import omnidir, random_pattern
    from opencv_contrib_tpu_torch.ops.image import warp_perspective

    rng = np.random.default_rng(seed)
    sy, sx = H / 480.0, W / 640.0
    blur = lambda a, s: filters.gaussian_blur(torch.from_numpy(a), s).numpy()  # noqa: E731

    # stereo: the background at 8 px, the box at 24 px
    d_bg, d_box = GEO_STEREO_DISP
    left = blur(rng.uniform(0, 1, (H, W)).astype(np.float32), 1.0)
    right = np.roll(left, -d_bg, axis=1)
    box = [int(round(160 * sy)), int(round(280 * sx)), int(round(319 * sy)), int(round(439 * sx))]
    by0, bx0, by1, bx1 = box
    right[by0:by1 + 1, bx0 - d_box:bx1 + 1 - d_box] = left[by0:by1 + 1, bx0:bx1 + 1]
    disparity = np.full((H, W), float(d_bg), np.float32)
    disparity[by0:by1 + 1, bx0:bx1 + 1] = d_box

    # gray code seen directly by the camera; PSP (4 steps, 40 periods)
    pats = structured_light.generate_graycode_patterns(W, H)[0].numpy()
    gain = rng.uniform(0.4, 0.8, (H, W)).astype(np.float32)
    offs = rng.uniform(0.0, 0.2, (H, W)).astype(np.float32)
    graycode = (pats * gain + offs + rng.normal(0, 0.01, pats.shape)).astype(np.float32)
    psp = structured_light.generate_psp_patterns(W, H, n_periods=40, n_shifts=4).numpy()

    # the FTP / FAPS scene
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    obj = 1.2 * np.exp(-(((yy - H / 2) / (30.0 * H / 128)) ** 2 + ((xx - W / 2) / (40.0 * W / 160)) ** 2))
    true = 2 * np.pi * 48 * xx / W + obj
    fringe = np.stack([0.5 + 0.45 * np.cos(true + 2 * np.pi * k / 3) for k in range(3)]).astype(np.float32)

    # reg: the blurred texture and its five warps
    reg_ref = blur(rng.uniform(size=(H, W)).astype(np.float32), 2.0) * 3
    motion = _reg_motions(H, W)
    reg_mov = np.stack([warp_perspective(torch.from_numpy(reg_ref), torch.from_numpy(M)).numpy() for M in motion])

    # ChArUco
    dictionary = markers.generate_dictionary(n_markers=12, bits=4)
    square = int(round(80 * min(sy, sx)))
    board, ids, centers = charuco.draw_charuco_board(dictionary, squares=GEO_SQUARES, square_px=square)
    origin = ((H - board.shape[0]) // 2, (W - board.shape[1]) // 2)
    frame = np.ones((H, W), np.float32)
    frame[origin[0]:origin[0] + board.shape[0], origin[1]:origin[1] + board.shape[1]] = board

    # ccalib: the random pattern and its shifted view; omnidir board views
    pattern = random_pattern.generate_pattern((H, W))
    f_omni = 600.0 * sx
    omni_K = np.array([[f_omni, 0, W / 2], [0, f_omni, H / 2], [0, 0, 1]], np.float32)
    gyb, gxb = np.meshgrid(np.arange(6), np.arange(8), indexing="ij")
    bpts = np.stack([gxb.ravel() * 0.08, gyb.ravel() * 0.08, np.zeros(48)], 1).astype(np.float32)
    bpts -= bpts.mean(0)
    omni_img = []
    for _ in range(6):
        w = 0.3 * rng.standard_normal(3).astype(np.float32)
        R = se3.exp_so3(torch.from_numpy(w))
        t = np.array([0.02, -0.01, 0.0], np.float32) + 0.08 * rng.standard_normal(3).astype(np.float32)
        t[2] = abs(t[2]) + 0.3
        px = omnidir.project_points_omni(torch.from_numpy(bpts), R, torch.from_numpy(t),
                                         torch.from_numpy(omni_K), 0.9).numpy()
        omni_img.append(px + 0.1 * rng.standard_normal(px.shape).astype(np.float32))

    # RAPID
    rapid_K = np.array([[120.0 * 4 * sx, 0, W / 2], [0, 120.0 * 4 * sy, H / 2], [0, 0, 1]], np.float32)
    rapid_t = np.array([0.0, 0.0, 3.0], np.float32)
    verts = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]], np.float32)

    # surface matching
    cloud, normals = _box_cloud(n_per_face=max(36, int(round(500 * sy))))
    T_ppf = se3.exp_se3(torch.tensor([0.2, 0.4, -0.1, 0.3, -0.2, 0.5])).numpy()
    T_icp = se3.exp_se3(torch.tensor([0.05, -0.04, 0.06, 0.05, 0.03, -0.04])).numpy()
    return GeometryScene(
        left=left, right=right, disparity=disparity, stereo_box=box, graycode=graycode, psp=psp,
        fringe=fringe, fringe_true=true.astype(np.float32), reg_ref=reg_ref, reg_mov=reg_mov.astype(np.float32),
        reg_motion=motion, charuco=frame, square_px=square, marker_span_px=int(0.75 * square) // 6 * 6 - 1,
        dictionary=dictionary, board_origin=origin, board_ids=ids,
        board_centers=centers, pattern=pattern, pattern_view=np.roll(pattern, (4, 7), (0, 1)),
        omni_obj=np.stack([bpts] * 6), omni_img=np.stack(omni_img).astype(np.float32), omni_K=omni_K,
        omni_xi=0.9, rapid_img=_render_square(rapid_K, rapid_t, (H, W)), rapid_K=rapid_K, rapid_t=rapid_t,
        rapid_t0=rapid_t + np.array([0.05, -0.04, 0.1], np.float32), rapid_vertices=verts,
        rapid_edges=np.array([[0, 1], [1, 2], [2, 3], [3, 0]]), cloud=cloud, cloud_normals=normals,
        cloud_T_ppf=T_ppf.astype(np.float32), cloud_T_icp=T_icp.astype(np.float32))


GEO_HOST_FIELDS = {"disparity", "stereo_box", "fringe_true", "reg_motion", "board_centers", "omni_xi", "square_px",
             "marker_span_px"}  # truths, host args


class _GScene:
    """A GeometryScene's float arrays on the device (each moved on first
    use), its ground truths and host arguments as they are."""

    def __init__(self, scene: GeometryScene, dev: torch.device):
        self.scene, self.dev, self._on = scene, dev, {}

    def __getattr__(self, name):
        v = getattr(self.scene, name)
        if name in GEO_HOST_FIELDS:
            return v
        if isinstance(v, torch.Tensor) or (isinstance(v, np.ndarray) and v.dtype.kind == "f"):
            if name not in self._on:
                self._on[name] = _f32(v, self.dev)
            return self._on[name]
        return v


def _lr_check(g: _GScene, **k):
    """Left-right check of the block-matched pair: the right view's
    disparity is block_match on the mirrored, swapped pair, mirrored back."""
    dl, _ = stereo.block_match(g.left, g.right, **k)
    dr, _ = stereo.block_match(torch.flip(g.right, (1,)), torch.flip(g.left, (1,)), **k)
    return dl, torch.flip(dr, (1,)), stereo.lr_consistency(dl, torch.flip(dr, (1,)))


def _graycode(g: _GScene, **k):
    ncb, nrb = int(np.ceil(np.log2(g.graycode.shape[2]))), int(np.ceil(np.log2(g.graycode.shape[1])))
    return structured_light.decode_graycode(g.graycode, ncb, nrb, **k)


def _reg(model: str):
    i = reg.MODELS.index(model)
    return lambda g, **k: reg.register_pyramid(g.reg_ref, g.reg_mov[i], model=model, **k)


def _charuco(g: _GScene, **k):
    ids, corners = aruco.detect_markers(g.charuco, g.dictionary)
    return charuco.interpolate_charuco_corners(ids, corners, g.board_ids, g.board_centers, square_px=g.square_px,
                                               **k)


def _marker_poses(g: _GScene, marker_length: float):
    H, W = g.charuco.shape
    K = constant([[GEO_FOCAL, 0, W / 2], [0, GEO_FOCAL, H / 2], [0, 0, 1]], g.dev)
    ids, corners = aruco.detect_markers(g.charuco, g.dictionary)
    return ids, charuco.estimate_pose_single_markers(corners, marker_length, K)


def _omni(g: _GScene, **k):
    return omnidir.calibrate_omni(list(g.omni_obj), list(g.omni_img), tuple(g.charuco.shape), **k)


def _rapid(g: _GScene, n_iters: int, search_len: float):
    """track with the search length of the JAX test's 160-px-wide frame
    scaled to the scene's width."""
    return rapid.track(g.rapid_img, g.rapid_K, torch.eye(3, device=g.dev), g.rapid_t0, g.rapid_vertices,
                       g.rapid_edges, n_iters=n_iters, search_len=search_len * g.rapid_img.shape[1] / 160)


def _scene_cloud(g: _GScene, T: torch.Tensor):
    R, t = T[:3, :3], T[:3, 3]
    return g.cloud @ R.T + t, g.cloud_normals @ R.T


def _ppf(g: _GScene, sampling_step: int, scene_step: int):
    """train_model, ppf_match, then register_model_to_scene from its pose
    (tests/test_surface_matching.py::TestPPF)."""
    model = surface_matching.train_model(g.cloud, g.cloud_normals, sampling_step=sampling_step)
    pts, nrm = _scene_cloud(g, g.cloud_T_ppf)
    T, votes = surface_matching.ppf_match(model, pts, nrm, scene_step=scene_step)
    T_ref, err = surface_matching.register_model_to_scene(g.cloud, pts, nrm, T_init=T)
    return T, votes, T_ref, err


def _cloud_icp(g: _GScene):
    pts, nrm = _scene_cloud(g, g.cloud_T_icp)
    return surface_matching.register_model_to_scene(g.cloud, pts, nrm)


# each method: (call on the scene, the settings of the JAX test that gates it, brought to VGA)
GEOMETRY = {
    "block_match": (lambda g, **k: stereo.block_match(g.left, g.right, **k), {"max_disp": 64}),
    "sgm_match": (lambda g, **k: stereo.sgm_match(g.left, g.right, **k), {"max_disp": 64}),
    "quasi_dense_stereo": (lambda g, **k: stereo.quasi_dense_stereo(g.left, g.right, **k),
                           {"max_disp": 64, "seed_stride": 8, "n_sweeps": 48}),
    "lr_consistency": (_lr_check, {"max_disp": 64}),
    "graycode": (_graycode, {}),
    "psp": (lambda g, **k: structured_light.compute_psp_phase(g.psp, **k), {}),
    "ftp": (lambda g, **k: sinusoidal.compute_ftp_phase(g.fringe[0], sinusoidal.compute_shadow_mask(g.fringe), **k),
            {}),
    "faps": (lambda g, **k: sinusoidal.compute_faps_phase(g.fringe, **k), {}),
    "unwrap_phase_dct": (lambda g, **k: phase_unwrapping.unwrap_phase_dct(sinusoidal.compute_faps_phase(g.fringe),
                                                                          **k), {}),
    **{f"reg_{m}": (_reg(m), {"levels": 3, "iters": 20}) for m in reg.MODELS},
    "detect_markers": (lambda g, **k: aruco.detect_markers(g.charuco, g.dictionary, **k), {}),
    "interpolate_charuco_corners": (_charuco, {"squares": GEO_SQUARES}),
    "estimate_pose_single_markers": (_marker_poses, {"marker_length": GEO_MARKER_M}),
    "find_correspondences": (lambda g, **k: ccalib.find_correspondences(g.pattern, g.pattern_view, **k),
                             {"max_keypoints": 512}),
    "calibrate_omni": (_omni, {"outer_iters": 60}),
    "calibrate_omni_fix_xi": (_omni, {"outer_iters": 60, "xi0": 0.9, "fix_xi": True}),
    "undistort_image_omni": (lambda g, **k: ccalib.undistort_image_omni(g.pattern, g.omni_K, **k), {"xi": 0.7}),
    "rapid_track": (_rapid, {"n_iters": 5, "search_len": 10.0}),
    "ppf": (_ppf, {"sampling_step": 3, "scene_step": 3}),
    "cloud_icp": (_cloud_icp, {}),
}


@f32_matmuls
def geometry_x(scene: GeometryScene, method: str, device="cuda"):
    """One geometry / calibration method beside the SfM stack (stereo BM /
    SGM / quasi-dense and the left-right check, Gray code, PSP, FTP, FAPS and
    the DCT unwrap, reg's five models, ArUco / ChArUco detection, corners and
    marker poses, the random-pattern corner finder, omnidir calibration and
    undistortion, RAPID, PPF with ICP and cloud ICP) on `scene` (a
    `geometry_scene()`; its float arrays may already be tensors on the
    device), with the settings of the JAX test that gates it, brought to the
    scene's size (`GEOMETRY`). Tensors stay on `device`; where the JAX
    package answers in numpy (marker ids and corners, ChArUco corners,
    marker poses, the random pattern's points, calibrate_omni's result) the
    answer is numpy."""
    if method not in GEOMETRY:
        raise ValueError(f"geometry_x: method must be one of {sorted(GEOMETRY)}, got {method!r}")
    dev = resolve(device)
    fn, settings = GEOMETRY[method]
    return fn(_GScene(scene, dev), **settings)


def sfm_scene(n_views: int = 100, n_points: int = 900, seed: int = 4, noise_px: float = 0.5,
              distortion: bool = True) -> tuple[TracksTensor, np.ndarray]:
    """A synthetic scene for `sfm.pipeline.reconstruct_incremental`: points
    seen by cameras on a half ring (`utils.synthetic.generate_scene`), with
    N(0, noise_px) pixel noise and lens distortion; by default 100 views of
    900 points, the view count of the reference's backyard pipeline gate.
    Returns (tracks, intr) as numpy: every visible point is a marker."""
    scene = generate_scene(n_views=n_views, n_points=n_points, seed=seed, noise_px=noise_px, distortion=distortion)
    return TracksTensor(obs=scene.points2d, mask=scene.visible), scene.intr


def sfm_sequence_scene(n_views: int = 5000, slots: int = 1024, seed: int = 0,
                       noise_px: float = 0.3) -> tuple[SparseTracks, np.ndarray, SequenceScene]:
    """A synthetic orbit for `sfm.pipeline_scale.reconstruct_sequential`
    (`utils.synthetic.generate_sequence_scene`) with N(0, noise_px) pixel
    noise, by scripts/sfm_scale_run.py's rule: tracks live max(24, V // 125)
    views (40 at 5,000 views: a 5k-view orbit turns ~0.07 deg a view, so
    triangulation needs long baselines), and the driver takes
    min_gap = max(3, track_span // 3). Returns (tracks, intr, scene), the
    scene holding the true poses and points; all numpy."""
    scene = generate_sequence_scene(n_views=n_views, slots_per_view=slots, track_span=max(24, n_views // 125),
                                    seed=seed, noise_px=noise_px)
    return from_sequence_scene(scene), scene.intr, scene


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One pass of the distributed layer over an n_devices mesh, the twin of
    `__graft_entry__.dryrun_multichip`: a 2 x n/2 ("dp", "sp") mesh from 4
    ranks up, else 1 x n; every rank of the process group calls it (one
    process alone gets a world-size-1 group). It runs the dense Schur BA
    with the observation grid sharded over the mesh (2 iterations), the
    sparse BA with the observations sharded over every axis, the ring
    all-pairs match over sp, and `reconstruct_sequential` with its global
    bundles sharded, each behind the JAX function's gate. Returns the
    gated numbers."""
    from opencv_contrib_tpu_torch.ba import sparse
    from opencv_contrib_tpu_torch.parallel import dist_ba, ring_match
    from opencv_contrib_tpu_torch.parallel.mesh import make_mesh

    n_dp, n_sp = (2, n_devices // 2) if n_devices >= 4 else (1, n_devices)
    mesh = make_mesh(n_dp, n_sp, device=device)
    dev = resolve(device)
    V, T = max(4, n_dp * 2), 64 * n_sp
    scene = generate_scene(n_views=V, n_points=T, seed=0)
    rng = np.random.default_rng(0)
    prob = bundle.make_problem_from_scene(scene.Rs, scene.ts,
                                          scene.points3d + rng.normal(scale=0.02, size=(T, 3)).astype(np.float32),
                                          scene.intr, scene.points2d, scene.visible, device=dev)
    out = {"mesh": [n_dp, n_sp]}

    def gate(ok: bool, what: str):
        if not ok:
            raise RuntimeError(f"dryrun_multichip: {what}: {out}")

    res = dist_ba.bundle_adjust(prob, mesh, n_iters=2)
    out["dense_cost"] = [float(res.initial_cost), float(res.final_cost)]
    gate(out["dense_cost"][1] <= out["dense_cost"][0], "the sharded dense BA raised the cost")
    sres = dist_ba.bundle_adjust_sparse(sparse.from_dense(prob), mesh, n_iters=2, n_cg=8)
    out["sparse_cost"] = [float(sres.initial_cost), float(sres.final_cost)]
    gate(out["sparse_cost"][1] <= out["sparse_cost"][0], "the sharded sparse BA raised the cost")

    N, K, D = 2 * n_sp, 16, 8
    descs = torch.from_numpy(np.random.default_rng(1).normal(size=(N, K, D)).astype(np.float32)).to(dev)
    idx, _, _ = ring_match.ring_all_pairs_match(descs, torch.ones((N, K), dtype=torch.bool, device=dev), mesh)
    out["ring_shape"] = list(idx.shape)
    gate(tuple(idx.shape) == (N, N, K), "the ring match's shape")

    sc = generate_sequence_scene(n_views=48, slots_per_view=32, track_span=7, seed=0, noise_px=0.2)
    tracks = from_sequence_scene(sc)
    rec = reconstruct_sequential(tracks, sc.intr, window=8, ba_every=4, min_gap=2, final_global_iters=2, mesh=mesh,
                                 device=device)
    out["registered"] = int(rec.registered.sum())
    out["mean_px"] = rec.reprojection_mean_px(tracks, device=device)
    gate(out["registered"] >= 36 and out["mean_px"] < 2.0, "the sequential reconstruction's gates")
    return out


# ---- tracking, videostab, superres ----------------------------------------------------------------------------


class TrackingScene(NamedTuple):
    """The fixtures of `track_x` (numpy float32 unless stated), the JAX
    tests' (tests/test_tracking.py, test_tracking_extra.py,
    test_breadth11.py::TestSiam) in one clip. H, W = frames.shape[1:].

    - `frames` (T, H, W): a Gaussian-blurred (sigma 2) U(0, 0.3) background
      with three 21 x 21 textures (blurred U(0.5, 1), sigma 1) pasted at the
      rounded `centers` (T, 3, 2) (y, x), and the Siamese test's 12 x 12
      U(0.5, 1) object at the integer `siam_centers` (T, 2) from (360, 120)
      at (3, 4) a frame. A is tests/test_tracking.py::_target_sequence()
      itself: its 128 x 128 background (numpy seed 0) laid into the frame
      with its corner at (60, 60) and its texture from (100, 100) at (2, 3)
      px a frame, on for the clip's length; B runs from (320, 420) at
      (1.5, -2), C from (150, 450) at (2, 2.5) (positions scaled with the
      frame, motions not).
    - `vanish` (H, W): the last frame without A (MOSSE's PSR drop).
    - `zoom` (Z, H, W), `zoom_kcf` and `zoom_const`: the DSST tests' 64 x
      64 U(0.2, 1) texture (numpy seed 0, their first draw) resized (linear)
      to `zoom_sizes` / `zoom_kcf_sizes` / 32 (24 -> 48 and 28 -> 48 over 20
      frames, 32 over 12) at the frame centre on a 0.1 background.
    - `kf_z` (30, 2): the KF test's noisy positions of (0, 0) at (1, 0.5) a
      step (its seed-0 noise); `ukf_z` (60, 2) and `ukf_truth` (60, 4): the
      UKF test's range-bearing run (its seed-0 noise).
    - `twist_uv` (N, 2), `twist_depths` (N,), `twist_K` (3, 3), `twist_duv`
      (N, 2) and `twist_xi` (6,): points at depths 2-4 seen by f = 500 at
      the frame centre, their velocities under the twist (float64
      interaction matrix).
    - `boxes`: a list of T (k, 4) (y0, x0, y1, x1) detections: A, B, C every
      frame and a fourth box on frames 10-14 (a track spawned, then killed
      after 5 misses)."""
    frames: np.ndarray
    centers: np.ndarray
    siam_centers: np.ndarray
    vanish: np.ndarray
    zoom: np.ndarray
    zoom_sizes: np.ndarray
    zoom_kcf: np.ndarray
    zoom_kcf_sizes: np.ndarray
    zoom_const: np.ndarray
    kf_z: np.ndarray
    ukf_z: np.ndarray
    ukf_truth: np.ndarray
    twist_uv: np.ndarray
    twist_depths: np.ndarray
    twist_K: np.ndarray
    twist_duv: np.ndarray
    twist_xi: np.ndarray
    boxes: list


TRACK_STARTS = ((100.0, 100.0), (320.0, 420.0), (150.0, 450.0))  # A, B, C at VGA
TRACK_FIXTURE_AT = (60, 60)  # the corner of A's 128 x 128 fixture at VGA: A starts at its (40, 40)
MOSSE_UPDATES = 11  # tests/test_tracking.py::TestMosse's updates: its fixture's 12 frames
TRACK_VELS = ((2.0, 3.0), (1.5, -2.0), (2.0, 2.5))
SIAM_START, SIAM_VEL, SIAM_SIDE = (360, 120), (3, 4), 12
TRACK_HALF = 10.5  # a target's detection box half side (21 px textures)
SPAWN_FRAMES = (10, 15)  # the transient fourth detection
UKF_DT = 0.1


def _blur_np32(a: np.ndarray, sigma: float) -> np.ndarray:
    return filters.gaussian_blur(torch.from_numpy(np.ascontiguousarray(a, np.float32)), sigma).numpy()


def _zoom_frames(rng, H: int, W: int, lo: int, hi: int, n: int = 20):
    from opencv_contrib_tpu_torch.ops.image import resize

    tex = torch.from_numpy(rng.uniform(0.2, 1.0, (64, 64)).astype(np.float32))
    sizes = np.linspace(lo, hi, n).astype(int)
    frames = np.full((n, H, W), 0.1, np.float32)
    for f, sz in zip(frames, sizes):
        y0, x0 = H // 2 - sz // 2, W // 2 - sz // 2
        f[y0:y0 + sz, x0:x0 + sz] = resize(tex, (int(sz), int(sz))).numpy()
    return frames, sizes


def _interaction_np(uv, Z, K):
    x = (uv[:, 0] - K[0, 2]) / K[0, 0]
    y = (uv[:, 1] - K[1, 2]) / K[1, 1]
    iZ = 1.0 / Z
    Lx = np.stack([-iZ, 0 * x, x * iZ, x * y, -(1 + x * x), y], 1)
    Ly = np.stack([0 * x, -iZ, y * iZ, 1 + y * y, -x * y, -x], 1)
    return np.stack([Lx, Ly], 1).reshape(-1, 6)


def tracking_scene(H: int = 480, W: int = 640, n_frames: int = 30, seed: int = 0) -> TrackingScene:
    """The fixtures of `track_x` at H x W over n_frames (`TrackingScene`)."""
    rng = np.random.default_rng(seed)
    sy, sx = H / 480.0, W / 640.0
    bg = _blur_np32(rng.uniform(0, 0.3, (H, W)), 2.0)
    fixture = np.random.default_rng(0)  # _target_sequence()'s draws, in its order
    oy, ox = int(round(TRACK_FIXTURE_AT[0] * sy)), int(round(TRACK_FIXTURE_AT[1] * sx))
    bg[oy:oy + 128, ox:ox + 128] = _blur_np32(fixture.uniform(0, 0.3, (128, 128)), 2.0)[:H - oy, :W - ox]
    texs = [_blur_np32(fixture.uniform(0.5, 1.0, (21, 21)), 1.0)]
    texs += [_blur_np32(rng.uniform(0.5, 1.0, (21, 21)), 1.0) for _ in TRACK_STARTS[1:]]
    obj = np.random.default_rng(11).uniform(0.5, 1.0, (SIAM_SIDE, SIAM_SIDE)).astype(np.float32)  # TestSiam's
    t = np.arange(n_frames, dtype=np.float64)[:, None, None]
    starts = np.array(TRACK_STARTS) * [sy, sx]
    starts[0] = (oy + 40.0, ox + 40.0)
    centers = (starts[None] + t * np.array(TRACK_VELS)[None]).astype(np.float32)  # (T, 3, 2)
    s0 = np.round(np.array(SIAM_START) * [sy, sx]).astype(int)
    siam = (s0[None] + np.arange(n_frames)[:, None] * np.array(SIAM_VEL)[None]).astype(np.float32)
    frames = np.repeat(bg[None], n_frames, 0)
    h = SIAM_SIDE // 2
    for f, cs, sc in zip(frames, centers, siam):
        for c, tex in zip(cs, texs):
            iy, ix = int(round(float(c[0]))) - 10, int(round(float(c[1]))) - 10
            f[iy:iy + 21, ix:ix + 21] = tex
        f[int(sc[0]) - h:int(sc[0]) + h, int(sc[1]) - h:int(sc[1]) + h] = obj
    vanish = bg.copy()
    for c, tex in list(zip(centers[-1], texs))[1:]:
        iy, ix = int(round(float(c[0]))) - 10, int(round(float(c[1]))) - 10
        vanish[iy:iy + 21, ix:ix + 21] = tex
    sc = siam[-1]
    vanish[int(sc[0]) - h:int(sc[0]) + h, int(sc[1]) - h:int(sc[1]) + h] = obj
    # each test's own fixture, from its own seed-0 generator
    zoom, zoom_sizes = _zoom_frames(np.random.default_rng(0), H, W, 24, 48)
    zoom_kcf, zoom_kcf_sizes = _zoom_frames(np.random.default_rng(0), H, W, 28, 48)
    zoom_const, _ = _zoom_frames(np.random.default_rng(0), H, W, 32, 32, n=12)
    noise = np.random.default_rng(0)  # TestKalman::test_linear_constant_velocity
    x_kf, kf_z = np.array([0.0, 0.0, 1.0, 0.5]), []
    for _ in range(30):
        x_kf = np.array([x_kf[0] + x_kf[2], x_kf[1] + x_kf[3], x_kf[2], x_kf[3]])
        kf_z.append(x_kf[:2] + noise.normal(scale=0.2, size=2))
    noise = np.random.default_rng(0)  # test_ukf_nonlinear_range_bearing
    x_true = np.array([2.0, 1.0, 0.5, -0.2])
    ukf_z, ukf_truth = [], []
    for _ in range(60):
        x_true = np.array([x_true[0] + UKF_DT * x_true[2], x_true[1] + UKF_DT * x_true[3], x_true[2], x_true[3]])
        ukf_z.append([np.hypot(x_true[0], x_true[1]) + noise.normal(scale=0.05),
                      np.arctan2(x_true[1], x_true[0]) + noise.normal(scale=0.005)])
        ukf_truth.append(x_true)
    # twist: 20 points at depths 2-4
    K = np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]])
    uv = rng.uniform([0.1 * W, 0.1 * H], [0.9 * W, 0.9 * H], size=(20, 2))
    Z = rng.uniform(2, 4, size=20)
    xi = np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.05])
    duv = (_interaction_np(uv, Z, K) @ xi).reshape(-1, 2) * [K[0, 0], K[1, 1]]
    boxes = []
    extra_box = np.array([[0.75 * H - 12, 0.1 * W - 12, 0.75 * H + 12, 0.1 * W + 12]], np.float32)
    for i in range(n_frames):
        b = np.concatenate([centers[i] - TRACK_HALF, centers[i] + TRACK_HALF], 1).astype(np.float32)
        boxes.append(np.concatenate([b, extra_box]) if SPAWN_FRAMES[0] <= i < SPAWN_FRAMES[1] else b)
    f32 = np.float32
    return TrackingScene(frames=frames, centers=centers, siam_centers=siam, vanish=vanish, zoom=zoom,
                         zoom_sizes=zoom_sizes, zoom_kcf=zoom_kcf, zoom_kcf_sizes=zoom_kcf_sizes, zoom_const=zoom_const,
                         kf_z=np.array(kf_z, f32),
                         ukf_z=np.array(ukf_z, f32), ukf_truth=np.array(ukf_truth, f32), twist_uv=uv.astype(f32),
                         twist_depths=Z.astype(f32), twist_K=K.astype(f32), twist_duv=duv.astype(f32),
                         twist_xi=xi.astype(f32), boxes=boxes)


TRACK_HOST_FIELDS = {"centers", "siam_centers", "zoom_sizes", "zoom_kcf_sizes", "ukf_truth", "twist_xi", "boxes"}


class _Scene:
    """A scene's numpy arrays on the device, each moved on first use (bool
    arrays as bool, the rest as float32); the fields named in `host`,
    tensors (already placed) and other values as they are."""

    def __init__(self, scene, dev: torch.device, host=frozenset()):
        self.scene, self.dev, self.host, self._on = scene, dev, host, {}

    def __getattr__(self, name):
        v = getattr(self.scene, name)
        if name in self.host or not isinstance(v, np.ndarray):
            return v
        if name not in self._on:
            self._on[name] = (constant(v, self.dev, torch.bool) if v.dtype == bool else to_device(v, self.dev))
        return self._on[name]


_SIAM_MODELS: dict = {}
SIAM_TRAIN = dict(n_steps=150, batch=16, seed=0)  # tests/test_breadth11.py's training


def siam_model(device="cuda"):
    """The Siamese backbone trained on `device` (the twin test's 150 steps x
    16 from seed 0), trained on first use and kept for the process."""
    from opencv_contrib_tpu_torch.tracking import siam

    dev = resolve(device)
    if dev not in _SIAM_MODELS:
        _SIAM_MODELS[dev] = siam.train_siam(**SIAM_TRAIN, device=dev)
    return _SIAM_MODELS[dev]


def _single(g: _Scene, init, step, **kw):
    """A single-target tracker over the clip: its centres (T, 2), frame 0
    the start, and its scores (T - 1,), all on the device."""
    frames = g.frames
    st = init(frames[0])
    centers, scores = [st.center if hasattr(st, "center") else st.box.center], []
    for i in range(1, frames.shape[0]):
        st, score = step(st, frames[i - 1], frames[i])
        centers.append(st.center if hasattr(st, "center") else st.box.center)
        scores.append(score)
    return st, torch.stack(centers), torch.stack(scores)


def _mosse(g: _Scene, size=(64, 64)):
    from opencv_contrib_tpu_torch.tracking import correlation

    st, c, s = _single(g, lambda f: correlation.mosse_init(f, g.centers[0, 0], size=size),
                       lambda st, prev, f: correlation.mosse_update(st, f))
    _, psr_vanish = correlation.mosse_update(st, g.vanish)
    return {"centers": c, "psr": s, "psr_vanish": psr_vanish}


def _kcf(g: _Scene, size=(64, 64)):
    from opencv_contrib_tpu_torch.tracking import correlation

    _, c, s = _single(g, lambda f: correlation.kcf_init(f, g.centers[0, 0], size=size),
                      lambda st, prev, f: correlation.kcf_update(st, f))
    return {"centers": c, "peak": s}


def _csrt(g: _Scene, target_hw=(21, 21)):
    from opencv_contrib_tpu_torch.tracking import csrt

    _, c, s = _single(g, lambda f: csrt.csrt_init(f, g.centers[0, 0], target_hw=target_hw),
                      lambda st, prev, f: csrt.csrt_update(st, f))
    return {"centers": c, "peak": s}


def _dsst(g: _Scene):
    """The DSST filter alone at the known centre on the constant 32 px clip
    (TestDsstScale::test_scale_stable_on_constant_size's frames): the
    scale each frame."""
    from opencv_contrib_tpu_torch.tracking import dsst

    z = g.zoom_const
    H, W = z.shape[1:]
    c = (H / 2.0, W / 2.0)
    s0 = 32
    st = dsst.dsst_init(z[0], c, (s0, s0))
    scales = []
    for f in z[1:]:
        st, s = dsst.dsst_update(st, f, c, (s0, s0))
        scales.append(s)
    return {"scale": torch.stack(scales)}


def _scaled(g: _Scene, kind: str):
    from opencv_contrib_tpu_torch.tracking import dsst

    z, sizes = (g.zoom, g.zoom_sizes) if kind == "csrt" else (g.zoom_kcf, g.zoom_kcf_sizes)
    H, W = z.shape[1:]
    init, update = (dsst.csrt_scale_init, dsst.csrt_scale_update) if kind == "csrt" else \
        (dsst.kcf_scale_init, dsst.kcf_scale_update)
    st = init(z[0], (H / 2.0, W / 2.0), target_hw=(int(sizes[0]), int(sizes[0])))
    centers, boxes = [], []
    for f in z[1:]:
        st, (c, box), _ = update(st, f)
        centers.append(c)
        boxes.append(box)
    return {"centers": torch.stack(centers), "boxes": torch.stack(boxes)}


def _kalman_models(dev):
    F = constant([[1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0], [0, 0, 0, 1]], dev)
    Hm = constant([[1, 0, 0, 0], [0, 1, 0, 0]], dev)
    return F, Hm, 1e-4 * torch.eye(4, device=dev), 0.04 * torch.eye(2, device=dev)


def _kf_run(g: _Scene, aukf: bool = False):
    from opencv_contrib_tpu_torch.tracking import kalman

    dev = g.dev
    F, Hm, Q, R = _kalman_models(dev)
    st = kalman.KalmanState(torch.zeros(4, device=dev), torch.eye(4, device=dev))
    for z in g.kf_z:
        if aukf:
            st = kalman.aukf_predict(st, lambda x, q: F @ x + q, Q)
            st = kalman.aukf_correct(st, z, lambda x, r: Hm @ x + r, R)
        else:
            st = kalman.kf_correct(kalman.kf_predict(st, F, Q), z, Hm, R)
    return {"x": st.x, "P": st.P}


def _ukf(g: _Scene):
    from opencv_contrib_tpu_torch.tracking import kalman

    dev = g.dev

    def f(x):
        return torch.stack([x[0] + UKF_DT * x[2], x[1] + UKF_DT * x[3], x[2], x[3]])

    def h(x):
        return torch.stack([torch.sqrt(x[0] ** 2 + x[1] ** 2), torch.atan2(x[1], x[0])])

    Q = 1e-5 * torch.eye(4, device=dev)
    R = torch.diag(constant([0.01, 1e-4], dev))
    st = kalman.KalmanState(constant([1.5, 1.5, 0.0, 0.0], dev), 0.5 * torch.eye(4, device=dev))
    for z in g.ukf_z:
        st = kalman.ukf_correct(kalman.ukf_predict(st, f, Q), z, h, R)
    return {"x": st.x, "P": st.P}


def _medianflow(g: _Scene):
    from opencv_contrib_tpu_torch.tracking import medianflow

    box0 = medianflow.Box(constant(g.centers[0, 0], g.dev), torch.full((2,), 20.0, device=g.dev))
    _, c, ok = _single(g, lambda f: box0, lambda st, prev, f: medianflow.medianflow_update(st, prev, f))
    return {"centers": c, "ok": ok}


def _tld(g: _Scene, seed: int = 1):
    from opencv_contrib_tpu_torch.tracking import tld

    gen = torch.Generator(device=g.dev).manual_seed(seed)
    bank = tld.fern_bank(gen)
    _, c, conf = _single(g, lambda f: tld.tld_init(f, g.centers[0, 0], (21.0, 21.0), bank=bank),
                         lambda st, prev, f: tld.tld_update(st, prev, f, bank))
    return {"centers": c, "conf": conf}


def _haar(kind: str):
    def run(g: _Scene, seed: int = 0, n_features: int = 120):
        from opencv_contrib_tpu_torch.tracking import boosting, mil

        gen = torch.Generator(device=g.dev).manual_seed(seed)
        bank = mil.make_feature_bank(gen, patch=32, n_features=n_features)
        init, update = (mil.mil_init, mil.mil_update) if kind == "mil" else \
            (boosting.boosting_init, boosting.boosting_update)
        _, c, s = _single(g, lambda f: init(f, g.centers[0, 0], gen, bank),
                          lambda st, prev, f: update(st, f, gen, bank))
        return {"centers": c, "score": s}

    return run


def _multi(g: _Scene, seed: int = 1):
    """MultiTracker with MOSSE on A, KCF on B and MedianFlow on C
    (tests/test_tracking_extra.py's mixed kinds): centres (T, 3, 2)."""
    from opencv_contrib_tpu_torch.tracking import multitracker

    mt = multitracker.MultiTracker(seed=seed, device=g.dev)
    frames, c0 = g.frames, g.centers[0]
    mt.add("mosse", frames[0], c0[0])
    mt.add("kcf", frames[0], c0[1])
    mt.add("medianflow", frames[0], (c0[2], (24.0, 24.0)))
    out = [constant(c0, g.dev)]
    for i in range(1, frames.shape[0]):
        out.append(torch.stack(mt.update(frames[i], prev_img=frames[i - 1])))
    return {"centers": torch.stack(out)}


def _by_matching(g: _Scene):
    """TrackerByMatching over the detections: the live (id, box) pairs of
    each frame (host lists)."""
    from opencv_contrib_tpu_torch.tracking import matching

    trk = matching.TrackerByMatching(max_cost=0.8, device=g.dev)
    return {"tracks": [trk.process(b) for b in g.boxes]}


def _twist(g: _Scene):
    from opencv_contrib_tpu_torch.tracking import twist

    return {"xi": twist.compute_twist(g.twist_uv, g.twist_duv, g.twist_depths, g.twist_K)}


def _siam(g: _Scene):
    from opencv_contrib_tpu_torch.tracking import siam

    model = siam_model(g.dev)
    y, x = (float(v) for v in g.siam_centers[0])
    h = SIAM_SIDE / 2
    st = siam.siam_init(model, g.frames[0], (y - h, x - h, SIAM_SIDE, SIAM_SIDE))
    centers, scores = [st.center], []
    for i in range(1, g.frames.shape[0]):
        st, _, score = siam.siam_update(model, st, g.frames[i])
        centers.append(st.center)
        scores.append(score)
    return {"centers": torch.stack(centers), "score": scores}


# each method: its run on the scene, with the settings of the JAX test that gates it
TRACKING = {
    "mosse": _mosse, "kcf": _kcf, "csrt": _csrt, "dsst": _dsst,
    "csrt_scale": lambda g: _scaled(g, "csrt"), "kcf_scale": lambda g: _scaled(g, "kcf"),
    "kalman": _kf_run, "ukf": _ukf, "aukf": lambda g: _kf_run(g, aukf=True), "medianflow": _medianflow,
    "tld": _tld, "mil": _haar("mil"), "boosting": _haar("boosting"), "multi": _multi,
    "by_matching": _by_matching, "twist": _twist, "siam": _siam,
}


@f32_matmuls
def track_x(scene: TrackingScene, method: str, device="cuda") -> dict:
    """One tracker or filter of the tracking module on `scene` (a
    `tracking_scene()`; its arrays may already be tensors on the device):
    MOSSE, KCF, CSRT, DSST and the scale-adaptive CSRT / KCF, the linear /
    unscented / augmented Kalman filters, MedianFlow, TLD, MIL, Boosting,
    the MultiTracker, TrackerByMatching, the twist and the Siamese tracker
    (the backbone trained on `device` on first use, `siam_model`), with the
    settings of the JAX test that gates each (`TRACKING`). Returns a dict of
    tensors on `device` (TrackerByMatching's tracks and the Siamese scores
    are host values, as the twins return them)."""
    if method not in TRACKING:
        raise ValueError(f"track_x: method must be one of {sorted(TRACKING)}, got {method!r}")
    return TRACKING[method](_Scene(scene, resolve(device), TRACK_HOST_FIELDS))


class ShakyClip(NamedTuple):
    """`stabilize_clip`'s input: `frames` (T, H, W), a blurred (sigma 2)
    U(0, 1) texture times 3 warped by a small similarity each frame
    (rotation N(0, 0.01) rad and shift N(0, 1.5) px about the centre);
    `warps` (T, 3, 3) those output -> input maps, so `motions` (T - 1, 3,
    3) = inv(warps[i + 1]) @ warps[i] map frame i to frame i + 1;
    `trajectory` (60, 2) the LP test's drift + N(0, 0.03) path (its seed-3
    draws); `hole` (H,
    W) bool, an inpainting mask."""
    frames: np.ndarray
    warps: np.ndarray
    motions: np.ndarray
    trajectory: np.ndarray
    hole: np.ndarray


def shaky_clip(H: int = 480, W: int = 640, n_frames: int = 16, seed: int = 0) -> ShakyClip:
    from opencv_contrib_tpu_torch.ops.image import warp_perspective

    rng = np.random.default_rng(seed)
    base = torch.from_numpy(_blur_np32(rng.uniform(size=(H, W)), 2.0) * 3)
    c = np.array([W / 2.0, H / 2.0])
    warps = []
    for _ in range(n_frames):
        a, t = rng.normal(0, 0.01), rng.normal(0, 1.5, 2)
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        M = np.eye(3)
        M[:2, :2], M[:2, 2] = R, c - R @ c + t
        warps.append(M)
    warps = np.array(warps)
    frames = np.stack([warp_perspective(base, torch.from_numpy(M.astype(np.float32))).numpy() for M in warps])
    motions = np.stack([np.linalg.inv(warps[i + 1]) @ warps[i] for i in range(n_frames - 1)])
    n = 60  # tests/test_videostab2.py::TestLpTrajectory's path, from its own seed-3 draws
    jitter = np.random.default_rng(3).normal(0, 0.03, (n, 2)).astype(np.float32)
    traj = np.stack([np.linspace(0, 1, n), np.zeros(n)], 1).astype(np.float32) + jitter
    hole = np.zeros((H, W), bool)
    hole[H // 3:H // 3 + H // 12, W // 3:W // 3 + W // 12] = True
    return ShakyClip(frames.astype(np.float32), warps.astype(np.float32), motions.astype(np.float32),
                     traj.astype(np.float32), hole)


STAB_RANSAC = dict(n_points=60, n_outliers=12, seed=0)  # tests/test_videostab2.py's 20% outliers
STAB_LP_BOUND = 0.08


def stab_ransac(clip: ShakyClip, dev: torch.device):
    """`stabilize_clip`'s RANSAC part, the one that draws: 60 point matches
    of frames 0 -> 1 under the clip's first motion with 12 outliers, and
    `videostab.ransac_motion` (similarity) on them, drawing from a
    generator on `dev`. Returns (M, inliers)."""
    from opencv_contrib_tpu_torch import videostab

    rng = np.random.default_rng(STAB_RANSAC["seed"])
    H, W = clip.frames.shape[1:]
    pts0 = rng.uniform([0, 0], [W, H], (STAB_RANSAC["n_points"], 2)).astype(np.float32)
    M = clip.motions[0].astype(np.float64)
    pts1 = (pts0 @ M[:2, :2].T + M[:2, 2]).astype(np.float32)
    pts1[:STAB_RANSAC["n_outliers"]] += rng.uniform(20, 40, (STAB_RANSAC["n_outliers"], 2)).astype(np.float32)
    gen = torch.Generator(dev).manual_seed(STAB_RANSAC["seed"])
    return videostab.ransac_motion(constant(pts0, dev), constant(pts1, dev), gen, model="similarity")


class Stabilized(NamedTuple):
    frames: list  # the stabilized frames (tensors)
    motions: torch.Tensor  # (T - 1, 4) estimated similarity parameters
    comp: torch.Tensor  # (T, 4) float64 compensations
    ransac: torch.Tensor  # (3, 3) RANSAC motion of frame 0 -> 1 from point matches
    ransac_inliers: torch.Tensor
    ransac_truth: np.ndarray  # (3, 3) the true motion
    lp: torch.Tensor  # the L1-optimal path of the clip's trajectory
    deblurred: torch.Tensor  # frame 2, blurred (sigma 2), then deblurred from frames 0-4
    blurred: torch.Tensor
    color_filled: torch.Tensor  # a constant 0.7 frame with the hole filled
    mosaic_filled: torch.Tensor  # frame 0 with the hole zeroed, filled from 4 copies of it (K = 4)
    wobble: torch.Tensor  # frame 3 with pass-1 = pass-2 motions (a no-op), period 5


@f32_matmuls
def stabilize_clip(clip: ShakyClip, device="cuda") -> Stabilized:
    """The videostab path on a shaky clip: `stabilize` (similarity, sigma
    1.5), `ransac_motion` on 60 point matches of frames 0 -> 1 with 12
    outliers, the L1-optimal path of the clip's trajectory, weighting
    deblur of a blurred frame from its neighbours, both inpainters and
    wobble suppression (the fixtures of tests/test_breadth2.py and
    test_videostab2.py, at the clip's size)."""
    from opencv_contrib_tpu_torch import videostab

    dev = resolve(device)
    frames = [to_device(f, dev) for f in clip.frames]
    stab, motions, comp = videostab.stabilize(frames, model="similarity", sigma=1.5)
    H, W = clip.frames.shape[1:]
    Mr, inl = stab_ransac(clip, dev)
    lp = videostab.lp_stabilize_trajectory(constant(clip.trajectory, dev), bound=STAB_LP_BOUND)
    mot = [constant(m, dev) for m in clip.motions]
    blurred = filters.gaussian_blur(frames[2], 2.0)
    deblurred = videostab.weighting_deblur(frames[:2] + [blurred] + frames[3:5], mot[:4], idx=2)
    hole = constant(clip.hole, dev, torch.bool)
    color = videostab.color_average_inpaint(torch.full((H, W), 0.7, device=dev), hole, n_iters=100)
    corrupted = torch.where(hole, torch.zeros((), device=dev), frames[0])
    eye = [torch.eye(3, device=dev)] * 4
    mosaic = videostab.consistent_mosaic_inpaint([frames[0], corrupted] + [frames[0]] * 3, eye, 1, hole, radius=2)
    wob = videostab.wobble_suppress(frames[3], 3, 5, mot, mot, torch.eye(3, device=dev))
    return Stabilized(stab, motions, comp, Mr, inl, clip.motions[0], lp, deblurred, blurred, color, mosaic, wob)


SUPERRES_SHIFTS = ((0, 0), (1.0, 0), (0, 1.0), (1.0, 1.0))  # tests/test_breadth2.py::TestSuperres, in HR px


class SuperRes(NamedTuple):
    known: torch.Tensor  # btv_l1 with the known flows (n_iters 25, lam 5e-3, ref 0)
    dis: torch.Tensor  # btv_l1 with DIS's flows (n_iters 25, lam 2e-2)
    hr: np.ndarray  # the high-res truth
    bicubic: torch.Tensor  # frame 0 upsampled (linear), the baseline
    frames: list  # the low-res frames


@f32_matmuls
def superres_clip(device="cuda", H: int = 240, W: int = 320, seed: int = 0) -> SuperRes:
    """4 low-res H x W frames of a blurred (sigma 1) U(0, 1) texture,
    shifted by SUPERRES_SHIFTS and area-downsampled by 2, fused to 2H x 2W
    by `superres.btv_l1`, once with the known flows and once with DIS's
    (tests/test_breadth2.py::TestSuperres at this size)."""
    from opencv_contrib_tpu_torch import superres
    from opencv_contrib_tpu_torch.ops.image import resize

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    hr = _blur_np32(rng.uniform(size=(2 * H, 2 * W)), 1.0)
    frames = []
    for dy, dx in SUPERRES_SHIFTS:
        shifted = warp_affine(torch.from_numpy(hr), torch.tensor([[1.0, 0.0, dx], [0.0, 1.0, dy]]))
        frames.append(to_device(resize(shifted, (H, W), method="area"), dev))
    flows = [constant([dy / 2, dx / 2], dev).expand(H, W, 2) for dy, dx in SUPERRES_SHIFTS]
    known = superres.btv_l1(frames, scale=2, n_iters=25, lam=5e-3, ref_index=0, flows=flows)
    est = superres.btv_l1(frames, scale=2, n_iters=25, lam=2e-2)
    return SuperRes(known, est, hr, resize(frames[0], (2 * H, 2 * W)), frames)


# ---- background subtraction and the retina ----------------------------------------------------------------------

# the JAX tests' sequences: (frames, seed, the test's frame side): the object's 10 px scale by W over that side,
# which keeps its motion a frame, (W - size) / (frames - 1), the same share of its size as in the test
BG_SEQUENCES = {"mog": (25, 1, 64), "cnt": (30, 2, 64), "gsoc": (24, 0, 48), "lsbp": (24, 3, 48)}
GMG_INIT = 22  # tests/test_breadth8.py::TestGmg's background frames, then one with the object
TRANSIENT_STEPS = 10
RETINA_RUNS = (10, 12)  # the parvo test's runs; the magno test's static runs (one moved run follows)
RETINA_SHIFT = 5  # px, the magno test's roll


class BackgroundClip(NamedTuple):
    """The fixtures of `background_x` (numpy float32 unless stated), each
    JAX test's own from its own seed at H x W (object sizes and regions
    scaled with the frame).

    - `mog`, `cnt`, `gsoc`, `lsbp` (T, H, W) with `*_masks` (T, H, W) bool:
      `bgsegm.synthetic_sequence` with each test's frame count and seed
      (BG_SEQUENCES; tests/test_bgsegm_stereo.py, test_breadth6.py), the
      object 10 W / side px (side: the test's frame side). `mog` also
      holds TestMog's own 64 x 64 sequence in its top-left corner
      (`mog_patch_masks` its object): MOG is per pixel, so the test's gate
      reads the same there as in the test (0.703 against 0.7), while the
      scaled object, 10,000 pixels a frame where the test has 100, reads
      the rate the test's draws overstate (0.633 in both packages); `static` (10, H, W): TestMog's static scene (seed 0:
      U(0, 1) plus N(0, 0.005) a frame).
    - `gmg` (GMG_INIT + 1, H, W): TestGmg's 0.5 background plus N(0, 0.01)
      (seed 1), then the 0.95 object over [10 s, 20 s)^2.
    - `retina_contrast` (H, W): the parvo test's U(0, 0.1) texture with its
      right half raised by 0.8; `retina_motion` (H, W): the magno test's U(0,
      1) image (both seed 0).
    - `magno` (TRANSIENT_STEPS, H, W): TestTransient's N(0, 0.01) magno
      frames (seed 0) with 0.5 added over rows [20 s, 40 s) x cols [24 s,
      44 s).
    - `hdr` (H, W): the tone-mapping test's exp(N(0, 2)) (seed 0); `color`
      (H, W, 3): U(0.1, 1) (seed 1); `smooth` (H, W, 3): the mux / demux
      test's smooth RGB; `retina_rgb` (H, W, 3): U(0, 1) (seed 2)."""
    mog: np.ndarray
    mog_masks: np.ndarray
    mog_patch_masks: np.ndarray
    cnt: np.ndarray
    cnt_masks: np.ndarray
    gsoc: np.ndarray
    gsoc_masks: np.ndarray
    lsbp: np.ndarray
    lsbp_masks: np.ndarray
    static: np.ndarray
    gmg: np.ndarray
    retina_contrast: np.ndarray
    retina_motion: np.ndarray
    magno: np.ndarray
    hdr: np.ndarray
    color: np.ndarray
    smooth: np.ndarray
    retina_rgb: np.ndarray


def bg_regions(H: int = 480, W: int = 640) -> dict:
    """The JAX tests' gate regions, scaled to H x W: (y0, y1, x0, x1)."""
    s6 = (H / 64.0, W / 64.0)  # the 64 x 64 retina and transient fixtures
    s4 = H / 48.0  # GMG's 48 x 48

    def box(y0, y1, x0, x1, sy, sx):
        return (int(round(y0 * sy)), int(round(y1 * sy)), int(round(x0 * sx)), int(round(x1 * sx)))

    return {"gmg_object": box(10, 20, 10, 20, s4, s4), "gmg_inside": box(12, 18, 12, 18, s4, s4),
            "gmg_outside": box(30, 48, 30, 48, s4, s4 * W / H),
            "retina_dark": box(8, 56, 4, 28, *s6), "retina_bright": box(8, 56, 36, 60, *s6),
            "magno_on": box(20, 40, 24, 44, *s6), "seg_inside": box(24, 36, 28, 40, *s6),
            "seg_corner": box(0, 10, 0, 10, *s6)}


def background_clip(H: int = 480, W: int = 640) -> BackgroundClip:
    """The fixtures of `background_x` at H x W (`BackgroundClip`)."""
    from opencv_contrib_tpu_torch.bgsegm import synthetic_sequence

    seqs = {}
    for name, (n, seed, side) in BG_SEQUENCES.items():
        fr = list(synthetic_sequence(n_frames=n, shape=(H, W), obj_size=int(round(10 * W / side)), seed=seed))
        seqs[name] = np.stack([f for f, _ in fr])
        seqs[name + "_masks"] = np.stack([m for _, m in fr])
    # TestMog's own 64 x 64 sequence in the top-left corner, clear of the scaled object's rows
    n, seed, side = BG_SEQUENCES["mog"]
    patch = list(synthetic_sequence(n_frames=n, shape=(side, side), seed=seed))
    seqs["mog"][:, :side, :side] = np.stack([f for f, _ in patch])
    seqs["mog_patch_masks"] = np.zeros_like(seqs["mog_masks"])
    seqs["mog_patch_masks"][:, :side, :side] = np.stack([m for _, m in patch])
    seqs["mog_masks"] |= seqs["mog_patch_masks"]
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(H, W)).astype(np.float32)
    static = np.stack([img + rng.normal(scale=0.005, size=(H, W)).astype(np.float32) for _ in range(10)])
    reg = bg_regions(H, W)
    rng = np.random.default_rng(1)
    bg = np.full((H, W), 0.5)
    gmg = [(bg + rng.normal(0, 0.01, bg.shape)).astype(np.float32) for _ in range(GMG_INIT)]
    y0, y1, x0, x1 = reg["gmg_object"]
    obj = bg.copy()
    obj[y0:y1, x0:x1] = 0.95
    gmg.append(obj.astype(np.float32))
    contrast = np.random.default_rng(0).uniform(size=(H, W)).astype(np.float32) * 0.1
    contrast[:, W // 2:] += 0.8
    motion = np.random.default_rng(0).uniform(size=(H, W)).astype(np.float32)
    rng = np.random.default_rng(0)
    y0, y1, x0, x1 = reg["magno_on"]
    magno = []
    for _ in range(TRANSIENT_STEPS):
        m = 0.01 * rng.standard_normal((H, W)).astype(np.float32)
        m[y0:y1, x0:x1] += 0.5
        magno.append(m)
    hdr = np.exp(np.random.default_rng(0).normal(0, 2.0, (H, W))).astype(np.float32)
    color = np.random.default_rng(1).uniform(0.1, 1.0, (H, W, 3)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = np.stack([0.3 + 0.3 * np.sin(xs / 15), 0.5 + 0.2 * np.cos(ys / 12),
                       0.4 + 0.1 * np.sin((xs + ys) / 20)], -1).astype(np.float32)
    retina_rgb = np.random.default_rng(2).uniform(size=(H, W, 3)).astype(np.float32)
    return BackgroundClip(**seqs, static=static, gmg=np.stack(gmg), retina_contrast=contrast, retina_motion=motion,
                          magno=np.stack(magno), hdr=hdr, color=color, smooth=smooth, retina_rgb=retina_rgb)


def _bg_mog(c: _Scene):
    from opencv_contrib_tpu_torch import bgsegm

    frames = c.mog
    st = bgsegm.mog_create(frames.shape[1:], device=c.dev)
    for f in frames[:10]:  # learn the background, then frames 15.. as the test does
        st, _ = bgsegm.mog_apply(st, f)
    fgs = []
    for f in frames[15:]:
        st, fg = bgsegm.mog_apply(st, f)
        fgs.append(fg)
    st_static = bgsegm.mog_create(frames.shape[1:], device=c.dev)
    for f in c.static:
        st_static, fg_static = bgsegm.mog_apply(st_static, f)
    return {"state": st, "fg": torch.stack(fgs), "fg_static": fg_static}


def _bg_cnt(c: _Scene):
    from opencv_contrib_tpu_torch import bgsegm

    frames = c.cnt
    st = bgsegm.cnt_create(frames.shape[1:], device=c.dev)
    for f in frames[:20]:
        st, _ = bgsegm.cnt_apply(st, f)
    st, fg = bgsegm.cnt_apply(st, frames[25])
    return {"state": st, "fg": fg}


def _bg_gmg(c: _Scene):
    from opencv_contrib_tpu_torch import bgsegm

    frames = c.gmg
    st = bgsegm.gmg_create(frames.shape[1:], device=c.dev)
    any_fg = torch.zeros((), dtype=torch.bool, device=c.dev)
    for f in frames[:GMG_INIT]:
        st, fg = bgsegm.gmg_apply(st, f)
        any_fg = any_fg | fg.any()
    st, fg = bgsegm.gmg_apply(st, frames[GMG_INIT])
    return {"state": st, "fg": fg, "init_any_fg": any_fg}


def _bg_gsoc(c: _Scene):
    from opencv_contrib_tpu_torch import bgsegm

    frames = c.gsoc
    st = bgsegm.gsoc_create(frames.shape[1:], device=c.dev)
    for f in frames:
        st, fg = bgsegm.gsoc_apply(st, f)
    return {"samples": st.samples, "hits": st.hits, "fg": fg}


def _bg_lsbp(c: _Scene):
    from opencv_contrib_tpu_torch import bgsegm

    frames = c.lsbp
    flat = bgsegm.lsbp_descriptor(torch.zeros((16, 16), device=c.dev))
    st = bgsegm.lsbp_create(frames.shape[1:], device=c.dev)
    for f in frames:
        st, fg = bgsegm.lsbp_apply(st, f)
    return {"samples": st.gsoc.samples, "hits": st.gsoc.hits, "desc": st.desc, "fg": fg, "flat_code": flat}


def _bg_retina_transient(c: _Scene):
    from opencv_contrib_tpu_torch import bioinspired

    shape = c.retina_contrast.shape
    r = bioinspired.Retina(shape, device=c.dev)
    for _ in range(RETINA_RUNS[0]):
        parvo, _ = r.run(c.retina_contrast)
    r = bioinspired.Retina(shape, device=c.dev)
    for _ in range(RETINA_RUNS[1]):
        _, magno_static = r.run(c.retina_motion)
    _, magno_moving = r.run(torch.roll(c.retina_motion, RETINA_SHIFT, 1))
    st = bioinspired.transient_create(shape, device=c.dev)
    for m in c.magno:
        st, seg = bioinspired.transient_run(st, m)
    return {"parvo": parvo, "magno_static": magno_static, "magno_moving": magno_moving, "transient": st, "seg": seg}


def _bg_retina_color(c: _Scene):
    from opencv_contrib_tpu_torch import bioinspired

    mosaic = bioinspired.color_multiplex(c.smooth)
    rec = bioinspired.color_demultiplex(mosaic)
    masks = bioinspired.bayer_masks(c.smooth.shape[:2], c.dev)
    r = bioinspired.Retina(c.retina_rgb.shape[:2], device=c.dev)
    parvo_rgb, magno = bioinspired.retina_run_color(r, c.retina_rgb)
    return {"mosaic": mosaic, "demux": rec, "masks_sum": masks.sum(0), "tone_gray": bioinspired.fast_tone_mapping(c.hdr),
            "tone_color": bioinspired.fast_tone_mapping(c.color), "parvo_rgb": parvo_rgb, "magno": magno}


BACKGROUND = {"mog": _bg_mog, "cnt": _bg_cnt, "gmg": _bg_gmg, "gsoc": _bg_gsoc, "lsbp": _bg_lsbp,
              "retina_transient": _bg_retina_transient, "retina_color": _bg_retina_color}
# frames (steps) a call of each method runs
BACKGROUND_FRAMES = {"mog": 20, "cnt": 21, "gmg": GMG_INIT + 1, "gsoc": BG_SEQUENCES["gsoc"][0],
                     "lsbp": BG_SEQUENCES["lsbp"][0], "retina_transient": sum(RETINA_RUNS) + 1 + TRANSIENT_STEPS,
                     "retina_color": 1}


def background_x(clip: BackgroundClip, method: str, device="cuda") -> dict:
    """One background subtractor or retina path on `clip` (a
    `background_clip()`), with the settings of the JAX test that gates it
    (`BACKGROUND`): MOG, CNT, GMG, GSOC and LSBP over their sequences (GSOC
    and LSBP drawing from a generator on `device` seeded 0, the twins'
    PRNGKey(0)), the retina's parvo and magno runs with the transient
    segmentation (three integral launches a step), or the color
    multiplexing, tone mapping and color retina. Returns a dict of tensors
    on `device`."""
    if method not in BACKGROUND:
        raise ValueError(f"background_x: method must be one of {sorted(BACKGROUND)}, got {method!r}")
    return BACKGROUND[method](_Scene(clip, resolve(device)))


# ---- detection, shape and face ------------------------------------------------------------------------------------

WB_WIN = 24  # tests/test_xobjdetect.py's window
WB_AT = (40, 30)  # the cross's corner in the test's 96 x 96 scene (scaled with the frame)
WB_STRIDE = 2
HOG_WIN_CELLS = (8, 8)  # TestHog::test_svm_detection's 64 x 64 window
HOG_AT = (32, 48)  # the target's corner in the test's 128 x 128 scene (scaled with the frame)
HOG_SCALES = (1.0, 0.84, 0.7)  # detect_multiscale's defaults
DPM_AT = (192, 272)  # the 96 x 96 DPM pattern's corner in a VGA frame (scaled with the frame)
FACE_IDS, FACE_PER_ID, FACE_SHAPE = 40, 10, (112, 92)  # the AT&T database's layout
EIGEN_COMPONENTS = 2 * FACE_IDS  # tests/test_face.py's 8 components for 4 identities
LBPH_GRID = 4
LBPH_NEW_LABEL = FACE_IDS  # the identity LBPH's update adds
BIF_FACES = 4  # gallery bases described at BIF's default 8 bands x 12 rotations
AAM_AT = (200, 300)  # the held-out AAM face's offset in a VGA frame (scaled with the frame)
FACEMARK_AT = (150, 400)  # the held-out Facemark face's offset in a VGA frame (scaled with the frame)
CONTOUR_POINTS = 300
EMD_DESCS = 32  # shape contexts of each contour in the EMD-L1 grid cost matrix


def _cross_patch(win, rng):
    """tests/test_xobjdetect.py::_cross_patch."""
    p = rng.uniform(0, 0.2, (win, win)).astype(np.float32)
    c = win // 2
    p[c - 2:c + 2, 4:-4] += 0.8
    p[4:-4, c - 2:c + 2] += 0.8
    return p


def _dpm_pattern(rng, deform=0):
    """tests/test_detect_breadth.py::TestDpm._pattern."""
    img = rng.uniform(0, 0.1, (96, 96)).astype(np.float32)
    img[40:72, 32:64] += 0.15
    img[44:52, 36:44] += 0.7
    img[60 + deform:68 + deform, 52:60] += 0.7
    return img


def _identity_images(rng, n_ids=4, n_per_id=6, shape=(32, 32)):
    """tests/test_face.py::_identity_images."""
    bases = [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(n_ids)]
    imgs, labels = [], []
    for i, b in enumerate(bases):
        for _ in range(n_per_id):
            gain = rng.uniform(0.7, 1.3)
            imgs.append(np.clip(gain * b + rng.normal(scale=0.05, size=shape), 0, 1.5).astype(np.float32))
            labels.append(i)
    return imgs, labels, bases


def _make_face(cy, cx, s, H=96, W=96):
    """tests/test_face.py::TestFacemarkAAM._make_face."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.zeros((H, W), np.float32)
    img[(((yy - cy) / (1.3 * s)) ** 2 + ((xx - cx) / s) ** 2) < 1] = 0.8
    ey, ex = cy - 0.4 * s, 0.45 * s
    for sx in (-1, 1):
        img[(((yy - ey) ** 2 + (xx - (cx + sx * ex)) ** 2) < (0.18 * s) ** 2)] = 0.2
    img[(np.abs(yy - (cy + 0.55 * s)) < 0.08 * s) & (np.abs(xx - cx) < 0.35 * s)] = 0.3
    img[(np.abs(yy - (cy + 0.1 * s)) < 0.12 * s) & (np.abs(xx - cx) < 0.07 * s)] = 0.5
    lm = np.array([[ey, cx - ex], [ey, cx + ex], [cy + 0.1 * s, cx], [cy + 0.55 * s, cx - 0.35 * s],
                   [cy + 0.55 * s, cx + 0.35 * s], [cy + 1.25 * s, cx]], np.float32)
    return img, lm


def _face_like(landmarks_px, shape=(96, 96)):
    """tests/test_breadth7.py::_face_like."""
    img = np.zeros(shape, np.float32)
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    img += 0.2 + 0.002 * yy
    for (y, x) in landmarks_px:
        img += 0.8 * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * 2.5 ** 2))
    return img.astype(np.float32)


def _at_scale(at, H: int, W: int):
    """A VGA position scaled to an H x W frame."""
    return int(round(at[0] * H / 480)), int(round(at[1] * W / 640))


def _box_of(lm):
    """TestFacemarkAAM's fitting box around landmarks: (y0, x0, h, w)."""
    lo, hi = lm.min(0), lm.max(0)
    return (lo[0] - 0.05 * (hi[0] - lo[0]), lo[1] - 0.05 * (hi[1] - lo[1]), 1.1 * (hi[0] - lo[0]),
            1.1 * (hi[1] - lo[1]))


def contours(n: int = CONTOUR_POINTS):
    """The shape methods' contours: a unit circle and the wavy closed curve
    of tests/test_breadth2.py::TestShape's shape-context test, n points each."""
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    circle = np.stack([np.cos(t), np.sin(t)], axis=1).astype(np.float32)
    wavy = np.stack([np.cos(t) * (1 + 0.3 * np.sign(np.cos(3 * t))), np.sin(t)], axis=1).astype(np.float32)
    return circle, wavy


class DetectionScene(NamedTuple):
    """The fixtures of `detect_x`, each JAX test's own from its own seed
    (the tests' `rng` is numpy's default_rng(0)) laid into H x W frames
    (numpy float32 unless stated; s = the frame over the test's scene).

    - WaldBoost (tests/test_xobjdetect.py::TestWaldBoost): `wb_model`, the
      port's model trained on the CPU on the test's 40 crosses and 40 noise
      patches over the port's pool (generator seed 0, 256 features, 16
      rounds); `wb_frame` U(0, 0.3) with the test's cross at WB_AT s;
      `wb_center` (2,) its centre.
    - HOG (TestHog::test_svm_detection): `hog_w` the one-shot SVM (the
      target's descriptor less its mean), `hog_frame` U(0, 0.05) with the
      target at HOG_AT s; `hog_at` (2,).
    - DPM (tests/test_detect_breadth.py::TestDpm): `dpm_model` built from the
      96 x 96 training pattern's features as the test builds it (host
      arrays, bias a float); `dpm_frame`, `dpm_deformed` U(0, 0.1) with the
      pattern and its deformed copy at `dpm_at` (DPM_AT s), `dpm_noise` U(0,
      1).
    - Faces (tests/test_face.py): `faces` (400, 112, 92) and `face_labels`
      (400,) int, `_identity_images` at the AT&T layout; `face_bases` (40,
      112, 92); `eigen_probes` and `fisher_probes` (40, 112, 92), the
      tests' 1.1 / 0.9 gains plus noise; `lbph_new` (3, 112, 92) and
      `lbph_new_base`, a new identity.
    - BIF (tests/test_breadth9.py::TestBIF): `bif_stripes`, `bif_a`,
      `bif_b` (112, 92).
    - AAM (TestFacemarkAAM): `aam_model` (CPU tensors) trained on the
      test's 12 faces; `aam_frame` with its held-out face at AAM_AT s,
      `aam_truth` (6, 2), `aam_box` (4,).
    - Facemark (tests/test_breadth7.py::TestFacemark): `fm_model` (CPU
      tensors) trained on the test's 24 faces; `fm_frame` with its held-out
      face at FACEMARK_AT s, `fm_truth` (5, 2), `fm_box` (3,).
    - Shape: `circle`, `wavy` (CONTOUR_POINTS, 2), `tps_src`, `tps_dst`
      (the TPS test's 12 points in [0, 10) and their moves; seed 0)."""
    wb_model: tuple
    wb_frame: np.ndarray
    wb_center: np.ndarray
    hog_w: np.ndarray
    hog_frame: np.ndarray
    hog_at: np.ndarray
    dpm_model: tuple
    dpm_frame: np.ndarray
    dpm_deformed: np.ndarray
    dpm_noise: np.ndarray
    dpm_at: np.ndarray
    faces: np.ndarray
    face_labels: np.ndarray
    face_bases: np.ndarray
    eigen_probes: np.ndarray
    fisher_probes: np.ndarray
    lbph_new: np.ndarray
    lbph_new_base: np.ndarray
    bif_stripes: np.ndarray
    bif_a: np.ndarray
    bif_b: np.ndarray
    aam_model: tuple
    aam_frame: np.ndarray
    aam_truth: np.ndarray
    aam_box: np.ndarray
    fm_model: tuple
    fm_frame: np.ndarray
    fm_truth: np.ndarray
    fm_box: np.ndarray
    circle: np.ndarray
    wavy: np.ndarray
    tps_src: np.ndarray
    tps_dst: np.ndarray


DETECT_HOST_FIELDS = {"wb_center", "hog_at", "face_labels", "aam_truth", "aam_box", "fm_truth", "dpm_model", "dpm_at"}


def _train_waldboost(rng):
    from opencv_contrib_tpu_torch.xobjdetect import waldboost

    pool = waldboost.make_feature_pool(torch.Generator().manual_seed(0), win=WB_WIN, n_features=256)
    pos = np.stack([_cross_patch(WB_WIN, rng) for _ in range(40)])
    neg = rng.uniform(0, 1, (40, WB_WIN, WB_WIN)).astype(np.float32)
    c = torch.tensor([[WB_WIN // 2, WB_WIN // 2]])
    fp = torch.cat([waldboost.window_features(torch.from_numpy(p), c, pool, win=WB_WIN) for p in pos])
    fn = torch.cat([waldboost.window_features(torch.from_numpy(n), c, pool, win=WB_WIN) for n in neg])
    return waldboost.train(fp, fn, pool, n_rounds=16, win=WB_WIN)


def detection_scene(H: int = 480, W: int = 640) -> DetectionScene:
    """The fixtures of `detect_x` at H x W (`DetectionScene`); the models
    are trained on the CPU here."""
    from opencv_contrib_tpu_torch.dpm.detector import DPMModel, _features
    from opencv_contrib_tpu_torch.face import aam, facemark
    from opencv_contrib_tpu_torch.xobjdetect import hog

    rng = np.random.default_rng(0)  # TestWaldBoost::test_detect_localizes
    wb_model = _train_waldboost(rng)
    wb_frame = rng.uniform(0, 0.3, (H, W)).astype(np.float32)
    wy, wx = int(round(WB_AT[0] * H / 96)), int(round(WB_AT[1] * W / 96))
    wb_frame[wy:wy + WB_WIN, wx:wx + WB_WIN] = _cross_patch(WB_WIN, rng)

    rng = np.random.default_rng(0)  # TestHog::test_svm_detection
    target = np.zeros((64, 64), np.float32)
    target[16:48, 28:36] = 1.0
    w = hog.hog_descriptor(torch.from_numpy(target), HOG_WIN_CELLS).numpy()
    hog_frame = rng.uniform(0, 0.05, (H, W)).astype(np.float32)
    hy, hx = int(round(HOG_AT[0] * H / 128)), int(round(HOG_AT[1] * W / 128))
    hog_frame[hy:hy + 64, hx:hx + 64] = np.maximum(hog_frame[hy:hy + 64, hx:hx + 64], target)

    rng = np.random.default_rng(0)  # TestDpm::test_detect_and_deformation_tolerance
    train = _dpm_pattern(rng)
    feat = _features(torch.from_numpy(train))
    nrm = lambda a: a / (torch.linalg.vector_norm(a) + 1e-6)  # noqa: E731
    dpm_model = DPMModel(root=nrm(feat[4:9, 3:8]).numpy(),
                         parts=torch.stack([nrm(feat[5:7, 4:6]), nrm(feat[7:9, 6:8])]).numpy(),
                         anchors=np.array([[1, 1], [3, 3]], np.int32), deform=np.full((2, 4), 0.05, np.float32),
                         bias=0.0)
    deformed = _dpm_pattern(rng, deform=6)
    noise = rng.uniform(0, 1, (H, W)).astype(np.float32)
    frames = []
    dy, dx = _at_scale(DPM_AT, H, W)
    for pat in (train, deformed):
        f = rng.uniform(0, 0.1, (H, W)).astype(np.float32)
        f[dy:dy + 96, dx:dx + 96] = pat
        frames.append(f)

    rng = np.random.default_rng(0)  # tests/test_face.py's dataset and probes
    imgs, labels, bases = _identity_images(rng, FACE_IDS, FACE_PER_ID, FACE_SHAPE)
    eigen_probes = [np.clip(1.1 * b + rng.normal(scale=0.05, size=b.shape), 0, 1.5) for b in bases]
    fisher_probes = [np.clip(0.9 * b + rng.normal(scale=0.05, size=b.shape), 0, 1.5) for b in bases]
    new_base = rng.uniform(0, 1, FACE_SHAPE).astype(np.float32)
    lbph_new = [np.clip(new_base + rng.normal(scale=0.05, size=FACE_SHAPE), 0, 1.5) for _ in range(3)]
    xs = np.arange(FACE_SHAPE[1])
    stripes = np.tile(np.sin(xs * 0.8), (FACE_SHAPE[0], 1)).astype(np.float32)
    rng = np.random.default_rng(4)
    bif_a, bif_b = (rng.uniform(size=FACE_SHAPE).astype(np.float32) for _ in range(2))

    rng = np.random.default_rng(0)  # TestFacemarkAAM::test_train_fit_held_out
    a_imgs, a_shapes = [], []
    for _ in range(12):
        img, lm = _make_face(44 + rng.uniform(-6, 6), 46 + rng.uniform(-6, 6), 22 + rng.uniform(-4, 5))
        a_imgs.append(img + rng.normal(0, 0.01, img.shape).astype(np.float32))
        a_shapes.append(lm)
    aam_model = aam.train(a_imgs, a_shapes, n_shape_modes=4, n_tex_modes=4)
    ay, ax = _at_scale(AAM_AT, H, W)
    aam_frame, aam_truth = _make_face(49 + ay, 43 + ax, 25, H, W)

    rng = np.random.default_rng(0)  # TestFacemark::test_train_and_fit
    base = np.array([[30, 30], [30, 60], [55, 45], [70, 35], [70, 55]], np.float32)
    f_imgs, f_shapes, f_boxes = [], [], []
    for _ in range(24):
        jitter = rng.normal(0, 2.0, base.shape).astype(np.float32)
        off = rng.uniform(-6, 6, 2).astype(np.float32)
        lm = base + jitter + off
        f_imgs.append(_face_like(lm))
        f_shapes.append(lm)
        f_boxes.append([lm[:, 0].min() - 10, lm[:, 1].min() - 10, 60.0])
    fm_model = facemark.train(f_imgs, np.stack(f_shapes), np.stack(f_boxes), n_stages=3)
    fm_truth = base + rng.normal(0, 2.0, base.shape).astype(np.float32) + np.array(_at_scale(FACEMARK_AT, H, W), np.float32)
    fm_frame = _face_like(fm_truth, (H, W))
    fm_box = np.array([fm_truth[:, 0].min() - 10, fm_truth[:, 1].min() - 10, 60.0], np.float32)

    circle, wavy = contours()
    rng = np.random.default_rng(0)  # TestShape::test_tps_interpolates_exactly
    tps_src = rng.uniform(0, 10, size=(12, 2)).astype(np.float32)
    tps_dst = tps_src + rng.normal(scale=0.5, size=(12, 2)).astype(np.float32)
    f32 = np.float32
    return DetectionScene(
        wb_model=wb_model, wb_frame=wb_frame, wb_center=np.array([wy + WB_WIN // 2, wx + WB_WIN // 2], f32),
        hog_w=(w - w.mean()).astype(f32), hog_frame=hog_frame, hog_at=np.array([hy, hx], f32),
        dpm_model=dpm_model, dpm_frame=frames[0], dpm_deformed=frames[1], dpm_noise=noise, dpm_at=np.array([dy, dx]),
        faces=np.stack(imgs), face_labels=np.array(labels, np.int32), face_bases=np.stack(bases),
        eigen_probes=np.stack(eigen_probes).astype(f32), fisher_probes=np.stack(fisher_probes).astype(f32),
        lbph_new=np.stack(lbph_new).astype(f32), lbph_new_base=new_base, bif_stripes=stripes, bif_a=bif_a, bif_b=bif_b,
        aam_model=aam_model, aam_frame=aam_frame, aam_truth=aam_truth, aam_box=np.array(_box_of(aam_truth), f32),
        fm_model=fm_model, fm_frame=fm_frame, fm_truth=fm_truth, fm_box=fm_box, circle=circle, wavy=wavy,
        tps_src=tps_src, tps_dst=tps_dst)


def _model_to(model, dev):
    """A model NamedTuple's tensor fields on `dev` (numpy fields become
    tensors; Python numbers stay)."""
    def one(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        return v.to(dev, non_blocking=True) if isinstance(v, torch.Tensor) else v
    return type(model)(*(one(v) for v in model))


def _det_waldboost(g: _Scene):
    from opencv_contrib_tpu_torch.xobjdetect import waldboost

    centers, scores = waldboost.detect(g.wb_frame, _model_to(g.wb_model, g.dev), stride=WB_STRIDE)
    return {"centers": centers, "scores": scores}


def _det_hog(g: _Scene):
    from opencv_contrib_tpu_torch.xobjdetect import hog

    boxes, scores = hog.detect_multiscale(g.hog_frame, g.hog_w, win_cells=HOG_WIN_CELLS, scales=HOG_SCALES,
                                          score_thresh=0.0)
    return {"boxes": boxes, "scores": scores}


def _det_dpm(g: _Scene):
    from opencv_contrib_tpu_torch import dpm

    model = _model_to(g.dpm_model, g.dev)
    return {k: dpm.detect(getattr(g, f), model, scales=(1.0,), score_thresh=2.0)
            for k, f in (("dets", "dpm_frame"), ("deformed", "dpm_deformed"), ("noise", "dpm_noise"))}


def _det_eigenfaces(g: _Scene):
    from opencv_contrib_tpu_torch.face import EigenFaces

    m = EigenFaces(n_components=EIGEN_COMPONENTS).train(g.faces, g.face_labels)
    return {"model": m.model, "predictions": [m.predict(p) for p in g.eigen_probes]}


def _det_fisherfaces(g: _Scene):
    from opencv_contrib_tpu_torch.face import FisherFaces

    m = FisherFaces().train(g.faces, g.face_labels)
    return {"model": m.model, "predictions": [m.predict(p) for p in g.fisher_probes]}


def _det_lbph(g: _Scene):
    from opencv_contrib_tpu_torch.face import LBPH

    m = LBPH(grid=LBPH_GRID).train(g.faces, g.face_labels)
    before = [m.predict(g.face_bases[1]), m.predict(2.0 * g.face_bases[3])]
    m.update(g.lbph_new, [LBPH_NEW_LABEL] * g.lbph_new.shape[0])
    return {"features": m.features, "predictions": before + [m.predict(g.lbph_new_base)]}


def _det_bif(g: _Scene):
    from opencv_contrib_tpu_torch.face import bif_features

    return {"faces": torch.stack([bif_features(b) for b in g.face_bases[:BIF_FACES]]),
            "a": bif_features(g.bif_a, 4, 6), "b": bif_features(g.bif_b, 4, 6),
            "stripes": bif_features(g.bif_stripes, 2, 4)}


def _det_aam(g: _Scene):
    from opencv_contrib_tpu_torch.face import aam

    model = _model_to(g.aam_model, g.dev)
    q0 = aam.init_params(model, g.aam_box)
    shape, q = aam.fit(model, g.aam_frame, q0)
    return {"init": aam._shape_from_params(model, q0), "shape": shape, "q": q}


def _det_facemark(g: _Scene):
    from opencv_contrib_tpu_torch.face import facemark

    model = _model_to(g.fm_model, g.dev)
    return {"shape": facemark.fit(model, g.fm_frame, g.fm_box), "mean_px": model.mean_shape * g.fm_box[2] + g.fm_box[:2]}


def _det_shape_context(g: _Scene):
    from opencv_contrib_tpu_torch import shape

    c, w = g.circle, g.wavy
    return {"same": shape.shape_context_distance(c, c * 2.0 + 5.0), "diff": shape.shape_context_distance(c, w),
            "haus_zero": shape.hausdorff_distance(c, c), "haus_offset": shape.hausdorff_distance(c, c + 0.5),
            "haus_rank": shape.hausdorff_distance(c, w, rank=0.9)}


def _det_tps(g: _Scene):
    from opencv_contrib_tpu_torch import shape

    params = shape.tps_fit(g.tps_src, g.tps_dst)
    sq = constant([[0, 0], [1, 0], [0, 1], [1, 1]], g.dev)
    shift = constant([2.0, -1.0], g.dev)
    q = constant([[0.5, 0.5], [3.0, 2.0]], g.dev)
    # the contours: the circle warped onto the wavy curve, applied to the circle itself and to a ring inside it
    cp = shape.tps_fit(g.circle, g.wavy)
    return {"interp": shape.tps_apply(params, g.tps_src, g.tps_src),
            "affine": shape.tps_apply(shape.tps_fit(sq, sq + shift), sq, q), "affine_truth": q + shift,
            "contour": shape.tps_apply(cp, g.circle, g.circle), "ring": shape.tps_apply(cp, g.circle, 0.5 * g.circle)}


def _det_emd(g: _Scene):
    from opencv_contrib_tpu_torch import shape

    dev = g.dev
    h1, h2 = constant(np.eye(10)[2], dev), constant(np.eye(10)[5], dev)  # TestEMD's unit masses
    g1, g2 = constant(np.eye(24)[8].reshape(4, 6), dev), constant(np.eye(24)[22].reshape(4, 6), dev)
    x1, x2, w = constant([[0.0, 0.0]], dev), constant([[2.0, 0.0]], dev), torch.ones(1, device=dev)
    da = shape.shape_context_descriptor(g.circle)[:EMD_DESCS]
    db = shape.shape_context_descriptor(g.wavy)[:EMD_DESCS]
    return {"shift": shape.emd_1d(h1, h2), "grid": shape.emd_l1_grid(g1, g2),
            "sinkhorn": shape.emd_sinkhorn(w, x1, w, x2, reg=0.01),
            "cost_1d": shape.emd_histogram_cost(da, db), "cost_grid": shape.emd_histogram_cost(da, db, (5, 12))}


AFFINE_TRUE = ((1.2, 0.3, 2.0), (-0.2, 0.9, -1.0))  # TestAffineTransformer's map
SIM_THETA, SIM_SCALE, SIM_T = 0.4, 1.3, (1.0, -2.0)


def _det_affine(g: _Scene):
    from opencv_contrib_tpu_torch import shape

    dev = g.dev
    M_true = constant(AFFINE_TRUE, dev)
    src = g.circle * 3.0 + g.wavy  # a spread of points off one line
    dst = src @ M_true[:, :2].T + M_true[:, 2]
    c, s = np.cos(SIM_THETA), np.sin(SIM_THETA)
    R = constant(SIM_SCALE * np.array([[c, -s], [s, c]]), dev)
    dst_sim = src @ R.T + constant(SIM_T, dev)
    M = shape.affine_fit(src, dst, True)
    rot = constant(np.concatenate([[[np.cos(0.7), -np.sin(0.7)], [np.sin(0.7), np.cos(0.7)]], np.zeros((2, 1))], 1),
                   dev)
    sheared = rot * constant([[2.5, 1.0, 1.0], [1.0, 1.0, 1.0]], dev)
    return {"M": M, "applied": shape.affine_apply(M, src), "dst": dst, "M_sim": shape.affine_fit(src, dst_sim, False),
            "R": R, "cost_rotation": shape.affine_transform_cost(rot), "cost_sheared": shape.affine_transform_cost(sheared)}


DETECTION = {"hog": _det_hog, "waldboost": _det_waldboost, "dpm": _det_dpm, "eigenfaces": _det_eigenfaces,
             "fisherfaces": _det_fisherfaces, "lbph": _det_lbph, "bif": _det_bif, "aam": _det_aam,
             "facemark": _det_facemark, "shape_context": _det_shape_context, "tps": _det_tps, "emd": _det_emd,
             "affine": _det_affine}


@f32_matmuls
def detect_x(scene: DetectionScene, method: str, device="cuda") -> dict:
    """One detector, recognizer, landmark fitter or shape method on `scene`
    (a `detection_scene()`), with the settings of the JAX test that gates
    it (`DETECTION`): HOG at the three default scales, WaldBoost at stride 2
    (its 8 channel tables one integral launch), DPM, EigenFaces (2
    components an identity), FisherFaces and LBPH trained on the gallery
    and asked its probes, BIF, AAM and Facemark fitting, shape context and
    Hausdorff distances, TPS, the EMDs and the affine transformer. Returns a
    dict of tensors on `device` (the recognizers' predictions and DPM's
    detections are host values, as the twins return them)."""
    if method not in DETECTION:
        raise ValueError(f"detect_x: method must be one of {sorted(DETECTION)}, got {method!r}")
    return DETECTION[method](_Scene(scene, resolve(device), DETECT_HOST_FIELDS))


# ---- hashes, saliency, lines, the colour chart, text and QR -------------------------------------------------------
HASH_FIXTURE = (64, 80)  # tests/test_imgproc_modules.py::TestImgHash's image
BING_SIZE, BING_STRIDE, BING_TOP_K = 32, 4, 8  # TestBing's window, stride and top-k on its 96 x 96 scene
LBD_LINES, LBD_CAP = 8, 8  # TestMIH::test_end_to_end_with_lbd's max_lines and bucket cap
MIH_DB, MIH_QUERIES, MIH_WORDS, MIH_FLIPS = 8192, 2048, 20, 2  # a matcher's size: 640-bit codes (36-dim LBD)
MIH_B, MIH_CAP, MIH_K = 8, 64, 2  # 80 tables of 256 buckets; the cap keeps every source (see `recognition_scene`)
# test_mcc_perspective.py's chart at its own size: `find_chart_cells` thresholds against a 19 x 19 box mean, so a
# larger cell's candidate is a ring that fills under 0.4 of its turned bounding box (at twice the size, 0.35)
MCC_CELL, MCC_GUTTER, MCC_SCALE, MCC_DEG = 22, 5, 1, 30.0
ER_LEVELS, ER_COMPONENTS, ER_MIN_AREAS = 8, 64, (12, 20)  # tests/test_text.py::TestEr's settings (areas at scale 1)
ER_NOISE = (64, 64)  # test_prob_filters_noise's patch
# the text lines and QR codes scale by k = H // 120 (4 at VGA): tests/test_text_ocr.py renders at scale 2 (8 at VGA),
# test_rendered_decode_perspective at 8 (a 360-pixel code at VGA), TestQrImage at 5 (10 at VGA)
OCR_SCALE, QR_SCALE, QR_NOISY_SCALE, QR_NOISY_AT = 2, 2, 2.5, (15, 62)
OCR_LEXICON = ("TRACK", "STACK", "TRUCK", "TRICK")
OCR_TEXTS = {"kinfu": "KINFU42", "track": "TRACK", "beam": "BEAM"}
QR_TEXTS = {"perspective": "PERSPECTIVE AT VERSION FOUR 0123456789", "noisy": "NOISY!"}


class RecognitionScene(NamedTuple):
    """The fixtures of `recognize_x`, each JAX test's own from its own seed
    (the tests' `rng` is numpy's default_rng(0)) laid into H x W frames,
    objects scaled with the frame (numpy float32 unless stated).

    - Hashes (tests/test_imgproc_modules.py::TestImgHash): `hash_a`, the
      test's blurred 64 x 80 x 3 image resized to the frame; `hash_noise`
      its 0.01 noise at the frame (the binary tests add it to channel 0);
      `hash_other` the binary tests' second image and `hash_other_color`
      the colour-moment test's, both resized.
    - Spectral residual (TestSaliency): `spectral_frame`, 0.5 with 0.01
      noise and the salient block; fine-grained: `fine_frame` U(0, 1).
    - BING (tests/test_breadth7.py::TestBing): `bing_frame`, U(0, 0.03) with
      the object; the test's window, stride and the object scaled by H / 96.
    - Motion (TestSaliency::test_motion_saliency): `motion_frames` (11, H,
      W), ten noisy copies of the base and the moved one.
    - Lines (tests/test_breadth10.py::TestMIH::test_end_to_end_with_lbd):
      `lines_frame` U(0, 1) with the bar.
    - MIH at a matcher's size: `mih_codes` (MIH_DB, MIH_WORDS) int32
      (random 32-bit words), `mih_queries` (MIH_QUERIES, MIH_WORDS) int32,
      the codes at `mih_src` (int64, distinct) with MIH_FLIPS distinct
      bits flipped. A bucket holds MIH_DB / 256 = 32 codes on average; at
      cap 16 a late code would be dropped from nearly every table, at
      MIH_CAP = 64 every source is probed.
    - Colour chart (tests/test_mcc_perspective.py): `mcc_frame`, the chart
      at MCC_SCALE of the test's size, turned MCC_DEG degrees about its
      centre onto the frame's centre by the test's nearest warp.
    - ER (tests/test_text.py::TestEr): `er_glyphs`, the test's four dark
      bars and `er_noise`, its 64 x 64 U(0.4, 0.6) patch, each scaled by
      one factor (`recognition_regions`' er_scale) into a white frame; the
      minimum areas scale by its square.
    - OCR (tests/test_text_ocr.py::TestHMM): `ocr_kinfu`, `ocr_track`,
      `ocr_beam`, each line rendered at OCR_SCALE k (k = H // 120) with the
      test's noise and seed, laid into a zero frame.
    - QR (tests/test_wechat_qrcode.py): `qr_perspective`, the version-4
      code at QR_SCALE k warped by the test's perspective, in a white
      frame; `qr_noisy`, TestQrImage's code at QR_NOISY_SCALE k at
      QR_NOISY_AT k, the frame with the test's 0.05 noise, clipped."""
    hash_a: np.ndarray
    hash_noise: np.ndarray
    hash_other: np.ndarray
    hash_other_color: np.ndarray
    spectral_frame: np.ndarray
    fine_frame: np.ndarray
    bing_frame: np.ndarray
    motion_frames: np.ndarray
    lines_frame: np.ndarray
    mih_codes: np.ndarray
    mih_queries: np.ndarray
    mih_src: np.ndarray
    mcc_frame: np.ndarray
    er_glyphs: np.ndarray
    er_noise: np.ndarray
    ocr_kinfu: np.ndarray
    ocr_track: np.ndarray
    ocr_beam: np.ndarray
    qr_perspective: np.ndarray
    qr_noisy: np.ndarray


RECOGNITION_HOST_FIELDS = {"mih_codes", "mih_queries", "mih_src"}


def recognition_regions(H: int = 480, W: int = 640) -> dict:
    """The JAX tests' objects and gate regions scaled to H x W: (y0, y1,
    x0, x1) boxes, and BING's window and stride."""
    def box(y0, y1, x0, x1, sy, sx):
        return (int(round(y0 * sy)), int(round(y1 * sy)), int(round(x0 * sx)), int(round(x1 * sx)))

    s96 = (H / 96.0, W / 96.0)
    s32 = (H / 32.0, W / 32.0)
    sb = H // 96  # BING's object, window and stride keep their square shape
    s64 = H / 64.0
    er = (float(min(H // 96, W // 160)),) * 2  # one scale: the ER gate scores aspect and compactness
    return {"spectral_block": box(40, 56, 40, 56, *s96), "spectral_top": int(round(30 * s96[0])),
            "bing_object": box(30, 62, 40, 72, sb, sb), "bing_size": BING_SIZE * sb, "bing_stride": BING_STRIDE * sb,
            "motion_block": box(10, 20, 10, 20, *s32), "motion_background": box(25, 32, 25, 32, *s32),
            "lines_bar": (int(round(20 * s64)), int(round(24 * s64))),
            "er_rows": box(30, 66, 0, 0, *er)[:2], "er_bars": [int(round(x * er[1])) for x in (30, 50, 70, 90)],
            "er_stroke": int(round(4 * er[1])), "er_hit": box(35, 60, 52, 50, *er),
            "er_scale": int(er[0]), "k": max(1, H // 120)}


def _hash_image(rng, H: int, W: int) -> np.ndarray:
    """TestImgHash._img: U(0, 1) at 64 x 80 x 3 blurred by sigma 2, resized to H x W."""
    from opencv_contrib_tpu_torch.ops.image import resize

    x = torch.from_numpy(rng.uniform(size=HASH_FIXTURE + (3,)).astype(np.float32))
    return resize(filters.gaussian_blur(x, 2.0), (H, W)).numpy()


def _chart_frame(H: int, W: int) -> np.ndarray:
    """test_mcc_perspective.py's chart at MCC_SCALE, turned MCC_DEG degrees
    about its centre onto the frame's centre by the test's nearest inverse
    warp (black outside)."""
    from opencv_contrib_tpu_torch.mcc import MACBETH_SRGB

    cell, gutter = MCC_CELL * MCC_SCALE, MCC_GUTTER * MCC_SCALE
    ref = np.asarray(MACBETH_SRGB, np.float32).reshape(4, 6, 3)
    img = np.zeros((4 * cell + 5 * gutter, 6 * cell + 7 * gutter, 3), np.float32)
    for r in range(4):
        for c in range(6):
            y0, x0 = gutter + r * (cell + gutter), gutter + c * (cell + gutter)
            img[y0:y0 + cell, x0:x0 + cell] = ref[r, c]
    th = np.radians(MCC_DEG)
    cs, sn = np.cos(th), np.sin(th)
    T1 = np.array([[1, 0, -img.shape[1] / 2], [0, 1, -img.shape[0] / 2], [0, 0, 1.0]])
    R = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1.0]])
    T2 = np.array([[1, 0, W / 2], [0, 1, H / 2], [0, 0, 1.0]])
    Hi = np.linalg.inv(T2 @ R @ T1)
    yy, xx = np.mgrid[0:H, 0:W]
    src = Hi @ np.stack([xx.ravel(), yy.ravel(), np.ones(H * W)])
    xi = np.round(src[0] / src[2]).astype(int)
    yi = np.round(src[1] / src[2]).astype(int)
    ok = (xi >= 0) & (xi < img.shape[1]) & (yi >= 0) & (yi < img.shape[0])
    out = np.zeros((H * W, 3), np.float32)
    out[ok] = img[yi[ok], xi[ok]]
    return out.reshape(H, W, 3)


def _lay(img: np.ndarray, H: int, W: int, at=None, fill: float = 0.0) -> np.ndarray:
    """img laid into an H x W frame of `fill`, at `at` (y, x) or centred."""
    h, w = img.shape
    y, x = at if at is not None else ((H - h) // 2, (W - w) // 2)
    out = np.full((H, W), fill, np.float32)
    out[y:y + h, x:x + w] = img
    return out


def recognition_scene(H: int = 480, W: int = 640) -> RecognitionScene:
    """The fixtures of `recognize_x` at H x W (`RecognitionScene`)."""
    from opencv_contrib_tpu_torch.ops.image import sample_bilinear
    from opencv_contrib_tpu_torch.text import ocr
    from opencv_contrib_tpu_torch.wechat_qrcode import qr

    reg = recognition_regions(H, W)
    rng = np.random.default_rng(0)  # the binary hash tests
    hash_a = _hash_image(rng, H, W)
    hash_noise = rng.normal(scale=0.01, size=(H, W)).astype(np.float32)
    hash_other = _hash_image(rng, H, W)
    rng = np.random.default_rng(0)  # TestImgHash::test_color_moment_hash
    _hash_image(rng, H, W)
    hash_other_color = _hash_image(rng, H, W)

    rng = np.random.default_rng(0)  # TestSaliency::test_spectral_residual_highlights_object
    spectral = np.full((H, W), 0.5, np.float32) + rng.normal(scale=0.01, size=(H, W)).astype(np.float32)
    y0, y1, x0, x1 = reg["spectral_block"]
    spectral[y0:y1, x0:x1] = 1.0
    fine = np.random.default_rng(0).uniform(size=(H, W)).astype(np.float32)  # test_fine_grained_runs
    rng = np.random.default_rng(0)  # TestBing::test_objectness_finds_object
    bing = rng.uniform(0, 0.03, (H, W)).astype(np.float32)
    y0, y1, x0, x1 = reg["bing_object"]
    bing[y0:y1, x0:x1] += 0.8
    rng = np.random.default_rng(0)  # test_motion_saliency
    base = rng.uniform(size=(H, W)).astype(np.float32)
    motion = [base + rng.normal(scale=0.003, size=base.shape).astype(np.float32) for _ in range(10)]
    moved = base.copy()
    y0, y1, x0, x1 = reg["motion_block"]
    moved[y0:y1, x0:x1] += 0.5
    motion.append(moved)

    rng = np.random.default_rng(5)  # TestMIH::test_end_to_end_with_lbd
    lines = rng.uniform(size=(H, W)).astype(np.float32)
    b0, b1 = reg["lines_bar"]
    lines[b0:b1, :] = 1.5
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 2 ** 32, (MIH_DB, MIH_WORDS), dtype=np.uint64).astype(np.uint32)
    src = rng.choice(MIH_DB, MIH_QUERIES, replace=False)
    bits = rng.random((MIH_QUERIES, MIH_WORDS * 32)).argsort(1)[:, :MIH_FLIPS]
    queries = codes[src].copy()
    for j in range(MIH_FLIPS):
        rows = np.arange(MIH_QUERIES)
        queries[rows, bits[:, j] // 32] ^= (np.uint32(1) << (bits[:, j] % 32).astype(np.uint32))

    er_glyphs = np.ones((H, W), np.float32)
    r0, r1 = reg["er_rows"]
    for x in reg["er_bars"]:
        er_glyphs[r0:r1, x:x + reg["er_stroke"]] = 0.0
    s = reg["er_scale"]  # test_prob_filters_noise's patch, scaled as the bars, in a white frame
    patch = np.random.default_rng(0).uniform(0.4, 0.6, ER_NOISE).astype(np.float32)
    er_noise = _lay(np.kron(patch, np.ones((s, s), np.float32)), H, W, fill=1.0)

    k = reg["k"]
    lines_ocr = {"kinfu": ocr.render_text(OCR_TEXTS["kinfu"], scale=OCR_SCALE * k),
                 "track": ocr.render_text(OCR_TEXTS["track"], scale=OCR_SCALE * k, noise=0.25,
                                          rng=np.random.default_rng(0)),
                 "beam": ocr.render_text(OCR_TEXTS["beam"], scale=OCR_SCALE * k, noise=0.1, rng=np.random.default_rng(1))}

    # tests/test_wechat_qrcode.py::test_rendered_decode_perspective
    img = qr.render(qr.encode(QR_TEXTS["perspective"], mask_id=5, level="M"), scale=QR_SCALE * k, border=6)
    H0, W0 = img.shape
    src4 = np.array([[0, 0], [0, W0 - 1], [H0 - 1, 0], [H0 - 1, W0 - 1]], float)
    dst4 = src4 + np.array([[6, 9], [3, -7], [-5, 6], [8, -4]], float) * (QR_SCALE * k / 8)  # scaled with the code
    Hm = qr._perspective_from_4([(r, c) for r, c in dst4], [(r, c) for r, c in src4])
    yy, xx = np.meshgrid(np.arange(H0), np.arange(W0), indexing="ij")
    p = np.stack([xx, yy, np.ones_like(xx)], -1) @ Hm.T
    warped = sample_bilinear(torch.from_numpy(img), torch.from_numpy((p[..., 1] / p[..., 2]).astype(np.float32)),
                             torch.from_numpy((p[..., 0] / p[..., 2]).astype(np.float32))).numpy()
    rng = np.random.default_rng(0)  # TestQrImage::test_detect_with_noise_and_offset
    noisy = _lay(qr.render(qr.encode(QR_TEXTS["noisy"]), scale=int(QR_NOISY_SCALE * k), border=6), H, W,
                 (QR_NOISY_AT[0] * k, QR_NOISY_AT[1] * k), 1.0)
    noisy = np.clip(noisy + rng.normal(0, 0.05, noisy.shape).astype(np.float32), 0, 1)
    return RecognitionScene(
        hash_a=hash_a, hash_noise=hash_noise, hash_other=hash_other, hash_other_color=hash_other_color,
        spectral_frame=spectral, fine_frame=fine, bing_frame=bing, motion_frames=np.stack(motion), lines_frame=lines,
        mih_codes=codes.view(np.int32), mih_queries=queries.view(np.int32), mih_src=src.astype(np.int64),
        mcc_frame=_chart_frame(H, W), er_glyphs=er_glyphs, er_noise=er_noise,
        ocr_kinfu=_lay(lines_ocr["kinfu"], H, W), ocr_track=_lay(lines_ocr["track"], H, W),
        ocr_beam=_lay(lines_ocr["beam"], H, W), qr_perspective=_lay(warped, H, W, fill=1.0), qr_noisy=noisy)


def _binary_hash(name: str):
    def run(g: _Scene):
        from opencv_contrib_tpu_torch import img_hash

        fn, a = getattr(img_hash, name), g.hash_a[..., 0]
        return {"a": fn(a), "noisy": fn(a + g.hash_noise), "other": fn(g.hash_other[..., 0])}
    return run


def _rec_color_moment(g: _Scene):
    from opencv_contrib_tpu_torch import img_hash

    return {"a": img_hash.color_moment_hash(g.hash_a), "scaled": img_hash.color_moment_hash(g.hash_a * 0.98),
            "other": img_hash.color_moment_hash(g.hash_other_color)}


def _rec_radial(g: _Scene):
    from opencv_contrib_tpu_torch import img_hash

    a = g.hash_a[..., 0]
    return {"a": img_hash.radial_variance_hash(a), "noisy": img_hash.radial_variance_hash(a + g.hash_noise),
            "other": img_hash.radial_variance_hash(g.hash_other[..., 0]),
            "rot180": img_hash.radial_variance_hash(torch.flip(a, (0, 1)))}


def _rec_spectral(g: _Scene):
    from opencv_contrib_tpu_torch import saliency

    return {"sal": saliency.spectral_residual(g.spectral_frame)}


def _rec_fine(g: _Scene):
    from opencv_contrib_tpu_torch import saliency

    return {"sal": saliency.fine_grained(g.fine_frame)}


def _rec_bing(g: _Scene):
    from opencv_contrib_tpu_torch import saliency

    H, W = g.bing_frame.shape
    reg = recognition_regions(H, W)
    boxes, scores = saliency.objectness_boxes(g.bing_frame, sizes=(reg["bing_size"],), stride=reg["bing_stride"],
                                              top_k=BING_TOP_K)
    return {"boxes": boxes, "scores": scores}


def _rec_motion(g: _Scene):
    from opencv_contrib_tpu_torch import saliency

    frames = g.motion_frames
    st = saliency.motion_create(frames.shape[1:], device=g.dev)
    for f in frames:
        st, sal = saliency.motion_apply(st, f)
    return {"sal": sal, "mean": st.mean, "var": st.var, "frames": st.frames}


def _rec_lines(g: _Scene):
    import opencv_contrib_tpu_torch.line_descriptor as ld

    segs, valid = ld.detect_line_segments(g.lines_frame, max_lines=LBD_LINES)
    desc = ld.lbd_describe(g.lines_frame, segs, valid)
    codes = ld.lbd_binarize(desc)
    idx, dist = ld.mih_knn_match(ld.mih_build(codes, b=MIH_B, cap=LBD_CAP), codes, k=1)
    return {"segments": segs, "valid": valid, "desc": desc, "codes": codes, "idx": idx, "dist": dist}


def _int32_on(x, dev):
    return x if isinstance(x, torch.Tensor) else constant(x, dev, torch.int32)


def _rec_mih(g: _Scene):
    import opencv_contrib_tpu_torch.line_descriptor as ld

    index = ld.mih_build(_int32_on(g.mih_codes, g.dev), b=MIH_B, cap=MIH_CAP)
    idx, dist = ld.mih_knn_match(index, _int32_on(g.mih_queries, g.dev), k=MIH_K)
    return {"buckets": index.buckets, "idx": idx, "dist": dist}


def _rec_mcc(g: _Scene):
    from opencv_contrib_tpu_torch import mcc

    M, measured = mcc.detect_and_fit_ccm(g.mcc_frame)
    return {"M": M, "measured": measured}


def _rec_er(g: _Scene):
    from opencv_contrib_tpu_torch.text import er

    s2 = recognition_regions(*g.er_glyphs.shape)["er_scale"] ** 2  # the areas scale with the fixtures
    kw = dict(n_levels=ER_LEVELS, max_components=ER_COMPONENTS)
    glyphs, probs = er.er_detect(g.er_glyphs, min_area=ER_MIN_AREAS[0] * s2, **kw)
    glyphs20, _ = er.er_detect(g.er_glyphs, min_area=ER_MIN_AREAS[1] * s2, **kw)
    noise20, _ = er.er_detect(g.er_noise, min_area=ER_MIN_AREAS[1] * s2, **kw)
    return {"glyphs": glyphs, "probs": probs, "glyphs_min_area": glyphs20, "noise_min_area": noise20}


def _ocr(use_beam: bool):
    def run(g: _Scene):
        from opencv_contrib_tpu_torch.text import ocr

        return {"kinfu": ocr.ocr_hmm(g.ocr_kinfu, use_beam=use_beam),
                "track": ocr.ocr_hmm(g.ocr_track, lexicon=list(OCR_LEXICON), use_beam=use_beam),
                "beam": ocr.ocr_hmm(g.ocr_beam, use_beam=use_beam)}
    return run


def _rec_qr(g: _Scene):
    from opencv_contrib_tpu_torch.wechat_qrcode import detect_and_decode

    out = {}
    for k in QR_TEXTS:
        text, corners = detect_and_decode(getattr(g, f"qr_{k}"))
        out[k], out[k + "_corners"] = text, corners
    return out


RECOGNITION = {**{n: _binary_hash(n) for n in ("average_hash", "block_mean_hash", "phash")},
               "color_moment_hash": _rec_color_moment, "radial_variance_hash": _rec_radial,
               "marr_hildreth_hash": _binary_hash("marr_hildreth_hash"), "spectral_residual": _rec_spectral,
               "fine_grained": _rec_fine, "bing": _rec_bing, "motion": _rec_motion, "lines_lbd": _rec_lines,
               "mih": _rec_mih, "mcc": _rec_mcc, "er": _rec_er, "ocr_viterbi": _ocr(False), "ocr_beam": _ocr(True),
               "qr": _rec_qr}


@f32_matmuls
def recognize_x(scene: RecognitionScene, method: str, device="cuda") -> dict:
    """One hash, saliency, line, colour-chart, text or QR method on `scene`
    (a `recognition_scene()`), with the settings of the JAX test that gates
    it (`RECOGNITION`): the six perceptual hashes of a frame, its noisy copy
    and another frame; spectral-residual and fine-grained saliency (one
    integral launch), BING (one integral launch), motion saliency over 11
    frames; lines detected, LBD-described, binarized and self-matched by
    MIH; MIH at a matcher's size (`RecognitionScene`); the chart found and
    its CCM fitted; the ER cascade; OCR by Viterbi or beam search; two QR
    codes decoded. Returns a dict of tensors on `device`, host numpy where
    the twin returns it (boxes, the chart's colours, QR corners) and
    strings for the decoded texts."""
    if method not in RECOGNITION:
        raise ValueError(f"recognize_x: method must be one of {sorted(RECOGNITION)}, got {method!r}")
    return RECOGNITION[method](_Scene(scene, resolve(device), RECOGNITION_HOST_FIELDS))
