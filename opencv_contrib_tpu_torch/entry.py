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

from opencv_contrib_tpu_torch import hfs, quality, ximgproc, xphoto  # noqa: I001
from opencv_contrib_tpu_torch.ba import bundle
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
from opencv_contrib_tpu_torch.utils import datasets, metrics, native, video
from opencv_contrib_tpu_torch.utils.device import constant, resolve
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
