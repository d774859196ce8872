"""Feature descriptors (the port of opencv_contrib_tpu/features/describe.py):
the SURF-class 64-d oriented gradient grid, DAISY (200-d with the defaults),
the BEBLID-class box-pair and the BRIEF-class point-pair binary descriptors.

Binary descriptors come back twice: bit-packed and as +-1 float signs, which
the Hamming matcher takes (`features.match`). The port's contract is
float32 / int32, so `pack_bits` gives int32 words: their `.view(np.uint32)`
is the JAX version's uint32 words bit for bit. The random sample patterns are
host numpy draws from the same seeds as the JAX version's, so they are the
same patterns.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops import integral as integ
from opencv_contrib_tpu_torch.ops.image import resize, sample_bilinear, sample_bilinear_multi
from opencv_contrib_tpu_torch.utils.device import constant


def surf_describe(img: torch.Tensor, kps: Keypoints, patch_cells: int = 4, cell_samples: int = 5) -> torch.Tensor:
    """Rotated 20s patch -> patch_cells^2 cells, each accumulating
    Gaussian-weighted (sum dx, sum|dx|, sum dy, sum|dy|) of rotated
    gradients. Returns (K, patch_cells^2 * 4), L2-normalized, zero rows for
    invalid keypoints."""
    g = filters.gaussian_blur(img, 1.0)
    gy, gx = filters.gradients(g)

    n = patch_cells * cell_samples  # samples across the patch
    u = (torch.arange(n, dtype=torch.float32, device=img.device) - n / 2 + 0.5) * (20.0 / n)
    gyy, gxx = torch.meshgrid(u, u, indexing="ij")  # (n, n)
    w = torch.exp(-(gxx ** 2 + gyy ** 2) / (2 * (3.3 * 2.0) ** 2))

    c = torch.cos(kps.angle)[:, None, None]
    s = torch.sin(kps.angle)[:, None, None]
    sc = kps.scale[:, None, None]

    px = kps.x[:, None, None] + sc * (c * gxx[None] - s * gyy[None])
    py = kps.y[:, None, None] + sc * (s * gxx[None] + c * gyy[None])

    sgx, sgy = sample_bilinear_multi(torch.stack([gx, gy]), py, px)
    rx = (c * sgx + s * sgy) * w[None]
    ry = (-s * sgx + c * sgy) * w[None]

    K = kps.capacity
    cells_x = rx.reshape(K, patch_cells, cell_samples, patch_cells, cell_samples)
    cells_y = ry.reshape(K, patch_cells, cell_samples, patch_cells, cell_samples)
    f1 = cells_x.sum(dim=(2, 4))
    f2 = torch.abs(cells_x).sum(dim=(2, 4))
    f3 = cells_y.sum(dim=(2, 4))
    f4 = torch.abs(cells_y).sum(dim=(2, 4))
    desc = torch.stack([f1, f2, f3, f4], dim=-1).reshape(K, -1)
    desc = desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-12)
    return desc * kps.valid[:, None]


def _orientation_maps(img: torch.Tensor, q_hist: int) -> torch.Tensor:
    """DAISY's layered gradients (q_hist, H, W): the gradient magnitude
    projected on q_hist directions, the negative lobe cut."""
    gy, gx = filters.gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    return torch.stack([mag * torch.clamp(torch.cos(ang - (2.0 * math.pi * k / q_hist - math.pi)), min=0.0)
                        for k in range(q_hist)])


def daisy_describe(img: torch.Tensor, kps: Keypoints, radius: float = 15.0, q_radius: int = 3, q_theta: int = 8,
                   q_hist: int = 8) -> torch.Tensor:
    """DAISY at the keypoints: (K, (q_radius * q_theta + 1) * q_hist), each
    histogram L2-normalised (NRM_PARTIAL). The orientation maps are smoothed
    at q_radius + 1 growing sigmas (the cubes); cubes of sigma >= 5 are
    smoothed at half resolution and resized back, as in the JAX version."""
    omaps = _orientation_maps(img, q_hist)
    sigmas = [radius * (l + 1) / q_radius / 2.0 for l in range(q_radius)]
    sigmas = [sigmas[0] / 2.0] + sigmas
    H, W = img.shape
    cubes = []
    prev, prev_sig = omaps, 0.0
    for sig in sigmas:
        inc = float(np.sqrt(max(sig ** 2 - prev_sig ** 2, 1e-6)))
        if sig >= 5.0:
            half = torch.stack([resize(m, (H // 2, W // 2)) for m in prev])
            sm = torch.stack([resize(m, (H, W)) for m in filters.fast_gaussian_blur(half, inc / 2.0)])
        else:
            sm = filters.fast_gaussian_blur(prev, inc)
        cubes.append(sm)
        prev, prev_sig = sm, sig
    ring_r = [radius * (r + 1) / q_radius for r in range(q_radius)]
    thetas = [2.0 * np.pi * t / q_theta for t in range(q_theta)]

    feats = [torch.movedim(sample_bilinear_multi(cubes[0], kps.y, kps.x), 0, -1)[:, None, :]]  # (K, 1, O)
    c, s = torch.cos(kps.angle), torch.sin(kps.angle)
    scale_f = kps.scale / 2.0 + 0.5
    dyv = constant([np.sin(t) for t in thetas], img.device)
    dxv = constant([np.cos(t) for t in thetas], img.device)
    for r in range(q_radius):
        dy, dx = ring_r[r] * dyv, ring_r[r] * dxv
        py = kps.y[None] + (s[None] * dx[:, None] + c[None] * dy[:, None]) * scale_f[None]
        px = kps.x[None] + (c[None] * dx[:, None] - s[None] * dy[:, None]) * scale_f[None]
        feats.append(sample_bilinear_multi(cubes[r + 1], py, px).permute(2, 1, 0))  # (K, T, O)
    desc = torch.cat(feats, dim=1)
    desc = desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-12)
    return desc.reshape(kps.capacity, -1) * kps.valid[:, None]


def make_box_pairs(n_bits: int = 256, patch: float = 16.0, seed: int = 42):
    """The BEBLID-class box-pair table (x1, y1), (x2, y2), radius per bit, as
    float32 tensors on the CPU: a fixed numpy draw in place of the reference's
    learned table."""
    rng = np.random.default_rng(seed)
    p1 = rng.normal(scale=patch / 3.5, size=(n_bits, 2)).clip(-patch, patch)
    p2 = rng.normal(scale=patch / 3.5, size=(n_bits, 2)).clip(-patch, patch)
    radius = rng.integers(1, 4, size=(n_bits,))
    return tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in (p1, p2, radius))


def _signs(bits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(bits, 1.0, -1.0) * valid[:, None]


def binary_boxes_describe(img: torch.Tensor, kps: Keypoints, n_bits: int = 256):
    """BEBLID-class binary descriptor: bit b = [mean of box 1 > mean of box
    2], the boxes scaled and rotated with the keypoint, their means read from
    the summed-area table. Returns (packed (K, n_bits // 32) int32, signs
    (K, n_bits) +-1 float32)."""
    p1, p2, rad = (constant(t, img.device) for t in make_box_pairs(n_bits))
    ii = integ.integral(img)
    c, s = torch.cos(kps.angle), torch.sin(kps.angle)
    sc = kps.scale / 2.0 + 0.5

    def box_avg(pts, radius):
        bx = kps.x[:, None] + sc[:, None] * (c[:, None] * pts[None, :, 0] - s[:, None] * pts[None, :, 1])
        by = kps.y[:, None] + sc[:, None] * (s[:, None] * pts[None, :, 0] + c[:, None] * pts[None, :, 1])
        r = torch.clamp((radius[None, :] * sc[:, None]).to(torch.int32), min=1)
        y0 = by.to(torch.int32) - r
        x0 = bx.to(torch.int32) - r
        wh = 2 * r + 1
        return integ.box_sum(ii, y0, x0, wh, wh) / (wh * wh)

    bits = (box_avg(p1, rad) - box_avg(p2, rad)) > 0
    return pack_bits(bits), _signs(bits, kps.valid)


def brief_describe(img: torch.Tensor, kps: Keypoints, n_bits: int = 256, patch: int = 24):
    """BRIEF-class point-pair binary descriptor on the image blurred at
    sigma 2, steered by the keypoint angle as ORB steers it. Returns
    (packed, signs)."""
    g = filters.gaussian_blur(img, 2.0)
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=patch / 5.0, size=(2, n_bits, 2)).clip(-patch / 2, patch / 2)
    pa, pb = (constant(p, img.device) for p in pts)
    c, s = torch.cos(kps.angle), torch.sin(kps.angle)
    sc = kps.scale / 2.0 + 0.5

    def sample(p):
        px = kps.x[:, None] + sc[:, None] * (c[:, None] * p[None, :, 0] - s[:, None] * p[None, :, 1])
        py = kps.y[:, None] + sc[:, None] * (s[:, None] * p[None, :, 0] + c[:, None] * p[None, :, 1])
        return sample_bilinear(g, py, px)

    bits = sample(pa) > sample(pb)
    return pack_bits(bits), _signs(bits, kps.valid)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., n_bits) bool -> (..., n_bits // 32) int32 words, bit i of a word
    being bit 32 w + i; `.view(np.uint32)` of them is the JAX version's
    uint32 words."""
    n = bits.shape[-1]
    if n % 32:
        raise ValueError(f"pack_bits: {n} bits is not a multiple of 32")
    b = bits.reshape(bits.shape[:-1] + (n // 32, 32)).to(torch.int64)
    words = torch.sum(b << torch.arange(32, device=bits.device), dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_to_signs(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(..., n_bits // 32) int32 words -> (..., n_bits) +-1 float32."""
    bits = ((packed.to(torch.int64)[..., :, None] >> torch.arange(32, device=packed.device)) & 1) > 0
    return torch.where(bits, 1.0, -1.0).reshape(packed.shape[:-1] + (n_bits,))
