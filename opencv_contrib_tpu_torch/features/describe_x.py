"""More xfeatures2d descriptors (the port of
opencv_contrib_tpu/features/describe_x.py): FREAK (retinal sampling with its
own orientation), LATCH (learned-arrangement triplets of mini-patches) and
LUCID (the rank order of blurred patch pixels).

FREAK samples one smoothed map a ring; the rings of sigma >= 3 are box-blur
approximations read from summed-area tables (`filters.fast_gaussian_blur`),
so on a CUDA tensor they launch the integral kernel. The binary descriptors
come back packed (int32, `describe.pack_bits`) and as +-1 signs for the
Hamming matcher. LUCID ranks with a stable argsort, as the JAX version's
`jnp.argsort` is stable: blurred patches of integer frames tie often.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.features.describe import _signs, pack_bits
from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.utils.device import constant


def _freak_pattern():
    """43 receptive fields: the centre and 7 rings of 6, radius and sigma
    growing outward. Returns (pts (43, 2) in patch units, ring id (43,)),
    the rings in order, so each ring's points are contiguous."""
    pts = [(0.0, 0.0)]
    ring = [0]
    for r in range(7):
        rad = 1.5 * (r + 1) ** 1.25
        phase = (r % 2) * np.pi / 6
        for t in range(6):
            a = 2 * np.pi * t / 6 + phase
            pts.append((rad * np.cos(a), rad * np.sin(a)))
            ring.append(r + 1)
    return np.asarray(pts, np.float32), np.asarray(ring, np.int32)


def _freak_pairs(pts: np.ndarray, n_bits: int) -> np.ndarray:
    """The first n_bits point pairs by descending summed radius (coarse to
    fine)."""
    P = pts.shape[0]
    pairs = [(i, j) for i in range(P) for j in range(i + 1, P)]
    r = np.linalg.norm(pts, axis=1)
    pairs.sort(key=lambda p: -(r[p[0]] + r[p[1]]))
    return np.asarray(pairs[:n_bits], np.int32)


_FREAK_SIGMAS = [0.5] + [0.6 * (r + 1) for r in range(7)]


def freak_describe(img: torch.Tensor, kps: Keypoints, n_bits: int = 512):
    """FREAK with its own orientation (the symmetric pairs of each ring).
    Returns (packed (K, n_bits // 32) int32, signs (K, n_bits), angle (K,))."""
    dev = img.device
    pts_np, ring_np = _freak_pattern()
    pts = constant(pts_np, dev)
    pairs = constant(_freak_pairs(pts_np, n_bits), dev, torch.int64)
    maps = [filters.fast_gaussian_blur(img, s) for s in _FREAK_SIGMAS]
    sc = kps.scale / 2.0 + 0.5
    bounds = np.searchsorted(ring_np, np.arange(len(_FREAK_SIGMAS) + 1))

    def sample_all(cos_a, sin_a):  # (43, K): each point from its ring's map
        px = kps.x[None] + sc[None] * (cos_a[None] * pts[:, 0:1] - sin_a[None] * pts[:, 1:2])
        py = kps.y[None] + sc[None] * (sin_a[None] * pts[:, 0:1] + cos_a[None] * pts[:, 1:2])
        return torch.cat([sample_bilinear(maps[r], py[a:b], px[a:b])
                          for r, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))])

    v0 = sample_all(torch.ones_like(kps.x), torch.zeros_like(kps.x))
    opp = []
    for ridx in range(1, 8):
        idxs = np.where(ring_np == ridx)[0]
        opp.extend((idxs[t], idxs[t + 3]) for t in range(3))
    opp = np.asarray(opp, np.int64)
    dvec = pts_np[opp[:, 0]] - pts_np[opp[:, 1]]
    dvec = constant(dvec / np.linalg.norm(dvec, axis=1, keepdims=True), dev)
    o = constant(opp, dev, torch.int64)
    dI = v0[o[:, 0]] - v0[o[:, 1]]
    angle = torch.atan2((dI * dvec[:, 1:2]).sum(0), (dI * dvec[:, 0:1]).sum(0))

    v = sample_all(torch.cos(angle), torch.sin(angle))
    bits = (v[pairs[:, 0]] - v[pairs[:, 1]] > 0).T
    return pack_bits(bits), _signs(bits, kps.valid), angle


def _latch_triplets(n_bits: int, patch: float, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(scale=patch / 3.0, size=(n_bits, 3, 2)).clip(-patch, patch).astype(np.float32)


def latch_describe(img: torch.Tensor, kps: Keypoints, n_bits: int = 256, half: int = 1):
    """LATCH: bit = [SSD(anchor, p1) < SSD(anchor, p2)] over (2 half + 1)^2
    mini-patches that rotate and scale with the keypoint. Returns (packed,
    signs)."""
    dev = img.device
    g = filters.gaussian_blur(img, 1.0)
    trip = constant(_latch_triplets(n_bits, 12.0), dev)
    r = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
    off = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)  # (w*w, 2) [dy, dx]
    c = torch.cos(kps.angle)[:, None, None, None]
    s = torch.sin(kps.angle)[:, None, None, None]
    sc = (kps.scale / 2.0 + 0.5)[:, None, None, None]
    px_pat = trip[:, :, 0][None, :, :, None] + off[None, None, None, :, 1]
    py_pat = trip[:, :, 1][None, :, :, None] + off[None, None, None, :, 0]
    px = kps.x[:, None, None, None] + sc * (c * px_pat - s * py_pat)
    py = kps.y[:, None, None, None] + sc * (s * px_pat + c * py_pat)
    vals = sample_bilinear(g, py, px)  # (K, B, 3, ww)
    a, p1, p2 = vals[:, :, 0], vals[:, :, 1], vals[:, :, 2]
    bits = ((a - p1) ** 2).sum(-1) < ((a - p2) ** 2).sum(-1)
    return pack_bits(bits), _signs(bits, kps.valid)


def lucid_describe(img: torch.Tensor, kps: Keypoints, patch: int = 7) -> torch.Tensor:
    """LUCID: the ranks of the box-blurred patch pixels, (K, patch^2) on
    [0, 1]; ties keep pixel order (stable argsort)."""
    g = filters.box_filter(img, 2)
    half = patch // 2
    off = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    vals = sample_bilinear(g, kps.y[:, None] + oy.reshape(-1)[None], kps.x[:, None] + ox.reshape(-1)[None])
    order = torch.argsort(vals, dim=-1, stable=True)
    P = vals.shape[1]
    ranks = torch.empty_like(vals).scatter_(
        1, order, torch.arange(P, dtype=torch.float32, device=img.device).expand_as(vals).contiguous())
    return ranks / (P - 1) * kps.valid[:, None]
