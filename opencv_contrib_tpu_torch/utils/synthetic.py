"""Synthetic scenes for tests and benchmarks — the port of
opencv_contrib_tpu/utils/synthetic.py:

- `generate_scene`: the random draws are the same numpy draws as the JAX
  version's; the geometry runs in torch on the CPU and the scene comes back
  as numpy arrays.
- `generate_sequence_scene`: pure numpy, as in the JAX package (its own
  `look_at_np`), so its arrays equal the JAX version's bit for bit."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.core import camera as cam


class SyntheticScene(NamedTuple):
    points3d: np.ndarray  # (P, 3)
    Rs: np.ndarray  # (V, 3, 3) world->cam
    ts: np.ndarray  # (V, 3)
    K: np.ndarray  # (3, 3)
    intr: np.ndarray  # (9,)
    points2d: np.ndarray  # (V, P, 2) pixel observations
    visible: np.ndarray  # (V, P) bool


class SequenceScene(NamedTuple):
    """Sparse per-view observations of a long camera trajectory — the input
    of the 5k-view driver (sfm/pipeline_scale.py).

    Slot layout: each view has K observation slots; tid/uv/ok give the track
    id, pixel position and validity per slot. This (V, K) layout is the
    camera-bucketed view the sparse BA wants, so the driver never builds a
    dense (V, T) grid."""

    tid: np.ndarray  # (V, K) int32 track ids
    uv: np.ndarray  # (V, K, 2) float32 pixels
    ok: np.ndarray  # (V, K) bool
    Rs: np.ndarray  # (V, 3, 3) ground-truth world->cam
    ts: np.ndarray  # (V, 3)
    points3d: np.ndarray  # (P, 3) ground truth
    intr: np.ndarray  # (9,)
    n_tracks: int


def _look_at_np(eye, target):
    """World->cam (R, t) looking from eye at target, +z forward, in numpy:
    the generator makes no per-view tensor calls."""
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    up = np.array([0.0, 1.0, 0.0], np.float64)
    right = np.cross(fwd, up)
    right = right / (np.linalg.norm(right) + 1e-12)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    return R.astype(np.float32), (-R @ eye).astype(np.float32)


def generate_sequence_scene(
    n_views: int = 256,
    slots_per_view: int = 128,
    track_span: int = 24,
    seed: int = 0,
    image_size=(640, 480),
    noise_px: float = 0.0,
) -> SequenceScene:
    """Long orbiting trajectory over a wall of points.

    Cameras ride a ring of radius 4 looking outward at an annulus of points
    at radius ~10; each point is angularly localized, so tracks live for
    ~track_span consecutive views (video-like visibility). Observations come
    out in (V, K) slot form, the most central K visible tracks of each view
    first."""
    rng = np.random.default_rng(seed)
    W, H = image_size
    f = 0.55 * W  # wide lens: the wall subtends ~1.2 rad from the ring
    intr = np.array([f, f, W / 2, H / 2, 0, 0, 0, 0, 0], np.float32)

    K = slots_per_view
    # each track is active for `span` consecutive views; the geometric field
    # of view (~0.19 * n_views) caps how long that can be
    span = int(np.clip(track_span, 3, max(3, int(0.15 * n_views))))
    n_tracks = max(K * 2, int(np.ceil(n_views * K / span)))
    # points on an outward wall: sorted angles, radius and height spread
    phi = np.sort(rng.uniform(0, 2 * np.pi, n_tracks)).astype(np.float64)
    rad = 10.0 + rng.uniform(-1.0, 1.0, n_tracks)
    height = rng.uniform(-1.5, 1.5, n_tracks)
    pts = np.stack([rad * np.sin(phi), height, -rad * np.cos(phi)], axis=1).astype(np.float32)
    # track p's active window is centred on the view pointing at it
    center_view = phi / (2 * np.pi) * n_views

    dphi = 0.6  # geometric half-arc of the wall inside the field of view

    tid = np.zeros((n_views, K), np.int32)
    uv = np.zeros((n_views, K, 2), np.float32)
    ok = np.zeros((n_views, K), bool)
    Rs = np.zeros((n_views, 3, 3), np.float32)
    ts = np.zeros((n_views, 3), np.float32)

    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        eye = np.array([4.0 * np.sin(th), 0.15 * np.sin(7 * th), -4.0 * np.cos(th)], np.float64)
        target = np.array([10.0 * np.sin(th), 0.0, -10.0 * np.cos(th)], np.float64)
        R, t = _look_at_np(eye, target)
        Rs[i], ts[i] = R, t

        # candidate tracks: wall angle within +-dphi of the view angle
        lo, hi = th - dphi, th + dphi
        cand = []
        for shift in (-2 * np.pi, 0.0, 2 * np.pi):
            a = np.searchsorted(phi, lo + shift)
            b = np.searchsorted(phi, hi + shift)
            cand.append(np.arange(a, b))
        cand = np.unique(np.concatenate(cand)) % n_tracks
        if cand.size == 0:
            continue
        # only tracks whose active window covers this view
        dv = (i - center_view[cand] + n_views / 2) % n_views - n_views / 2
        cand = cand[np.abs(dv) <= span / 2]
        if cand.size == 0:
            continue
        Xc = pts[cand] @ R.T + t
        z = Xc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        px = np.stack([intr[0] * Xc[:, 0] / zs + intr[2], intr[1] * Xc[:, 1] / zs + intr[3]], axis=1)
        vis = (z > 0.5) & (px[:, 0] >= 1) & (px[:, 0] < W - 1) & (px[:, 1] >= 1) & (px[:, 1] < H - 1)
        vi = np.flatnonzero(vis)
        if vi.size == 0:
            continue
        # prefer central slots: smallest angular distance to the view axis
        dist = np.abs((phi[cand[vi]] - th + np.pi) % (2 * np.pi) - np.pi)
        keep = vi[np.argsort(dist, kind="stable")[:K]]
        n = keep.size
        tid[i, :n] = cand[keep]
        p = px[keep]
        if noise_px > 0:
            p = p + rng.normal(scale=noise_px, size=p.shape)
        uv[i, :n] = p.astype(np.float32)
        ok[i, :n] = True

    return SequenceScene(tid=tid, uv=uv, ok=ok, Rs=Rs, ts=ts, points3d=pts, intr=intr, n_tracks=n_tracks)


def generate_scene(
    n_views: int = 8,
    n_points: int = 200,
    seed: int = 0,
    image_size=(640, 480),
    radius: float = 4.0,
    noise_px: float = 0.0,
    distortion: bool = False,
) -> SyntheticScene:
    """Random cloud of points near the origin seen by cameras on a half
    ring looking in; observations exact plus optional Gaussian pixel noise."""
    rng = np.random.default_rng(seed)
    W, H = image_size
    f = 0.9 * W
    if distortion:
        intr = np.array([f, f, W / 2, H / 2, -0.1, 0.02, 0.0, 1e-3, -5e-4], np.float32)
    else:
        intr = np.array([f, f, W / 2, H / 2, 0, 0, 0, 0, 0], np.float32)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]], np.float32)

    pts = rng.uniform(-1.0, 1.0, size=(n_points, 3)).astype(np.float32)
    intr_t = torch.from_numpy(intr)
    pts_t = torch.from_numpy(pts)

    Rs, ts, obs, vis = [], [], [], []
    for i in range(n_views):
        angle = 2.0 * np.pi * i / max(n_views, 1) * 0.5  # half ring
        eye = np.array(
            [radius * np.sin(angle), 0.4 * rng.standard_normal(), -radius * np.cos(angle)],
            np.float32,
        )
        target = rng.uniform(-0.2, 0.2, size=3).astype(np.float32)
        R, t = cam.look_at(torch.from_numpy(eye), torch.from_numpy(target))
        px, z = cam.project(intr_t, R, t, pts_t)
        R, t, px, z = R.numpy(), t.numpy(), px.numpy(), z.numpy()
        v = (z > 0.1) & (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
        if noise_px > 0:
            px = px + rng.normal(scale=noise_px, size=px.shape).astype(np.float32)
        Rs.append(R)
        ts.append(t)
        obs.append(px)
        vis.append(v)

    return SyntheticScene(
        points3d=pts,
        Rs=np.stack(Rs),
        ts=np.stack(ts),
        K=K,
        intr=intr,
        points2d=np.stack(obs).astype(np.float32),
        visible=np.stack(vis),
    )
