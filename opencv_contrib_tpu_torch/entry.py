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

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch import quality, xphoto
from opencv_contrib_tpu_torch.ba import bundle
from opencv_contrib_tpu_torch.core import camera as cam
from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.core.color import rgb_to_gray
from opencv_contrib_tpu_torch.features import describe, detect, match
from opencv_contrib_tpu_torch.flow import dis, extra, pcaflow, tvl1
from opencv_contrib_tpu_torch.intensity_transform import gamma_correction
from opencv_contrib_tpu_torch.mvg import resection
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.histogram import clahe
from opencv_contrib_tpu_torch.ops.image import warp_affine
from opencv_contrib_tpu_torch.rgbd import kinfu, odometry, submap
from opencv_contrib_tpu_torch.rgbd.dynafu import DynaFu
from opencv_contrib_tpu_torch.rgbd.hash_tsdf import HashTSDF
from opencv_contrib_tpu_torch.rgbd.tsdf import TSDFVolume
from opencv_contrib_tpu_torch.sfm.pipeline_scale import SparseTracks, from_sequence_scene, reconstruct_sequential
from opencv_contrib_tpu_torch.sfm.tracks import TracksTensor
from opencv_contrib_tpu_torch.utils import datasets, metrics, native
from opencv_contrib_tpu_torch.utils.device import resolve
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls
from opencv_contrib_tpu_torch.utils.synthetic import SequenceScene, generate_scene, generate_sequence_scene


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
