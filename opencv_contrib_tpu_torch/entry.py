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
- `dense_flow(I0, I1, method)`: DIS-class or TV-L1 dense optical flow;
  `flow_pair()` makes a textured pair at MPI-Sintel's 436 x 1024 with its
  true flow.
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
from opencv_contrib_tpu_torch.core.color import rgb_to_gray
from opencv_contrib_tpu_torch.features import describe, detect, match
from opencv_contrib_tpu_torch.flow import dis, tvl1
from opencv_contrib_tpu_torch.intensity_transform import gamma_correction
from opencv_contrib_tpu_torch.mvg import resection
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.histogram import clahe
from opencv_contrib_tpu_torch.ops.image import warp_affine
from opencv_contrib_tpu_torch.rgbd import kinfu
from opencv_contrib_tpu_torch.rgbd.tsdf import TSDFVolume
from opencv_contrib_tpu_torch.sfm.pipeline_scale import SparseTracks, from_sequence_scene
from opencv_contrib_tpu_torch.sfm.tracks import TracksTensor
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


def kinfu_bench_frames(n: int, H: int = 480, W: int = 640) -> np.ndarray:
    """The depth ramp of `bench.py::bench_kinfu_vga512` (`base + 0.002 * i`
    for frame i, in meters): (n, H, W) float32."""
    base = (2.0 + 0.3 * np.sin(np.linspace(0, 6, W))[None, :]
            + 0.2 * np.cos(np.linspace(0, 4, H))[:, None]).astype(np.float32)
    return np.stack([base + 0.002 * i for i in range(n)])


FLOW_METHODS = {"dis": dis.compute, "tvl1": tvl1.compute}


@f32_matmuls
def dense_flow(I0, I1, method: str = "dis", device="cuda", **params) -> torch.Tensor:
    """Dense flow I0 -> I1 of two (H, W) frames: (H, W, 2) as (dy, dx), on
    `device`. `method` "dis" (`flow.dis.compute`) or "tvl1"
    (`flow.tvl1.compute`); `params` go to it (levels, ...)."""
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
