"""BIF — biologically inspired features for face/age analysis (the port of
opencv_contrib_tpu/face/bif.py).

Reference anchor: face/src/bif.cpp (cv::face::BIF::create(num_bands,
num_rotations)): a bank of Gabor filters over num_bands scale bands x
num_rotations orientations; within each band, responses of two consecutive
Gabor scales are combined with max pooling over local grids (HMAX C1 units),
then standard-deviation-pooled into the output feature vector.

The whole Gabor bank is one `F.conv2d` with SAME zero padding, in full f32
on the card; the standard deviations are the population ones (ddof 0, as
`jnp.std`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.utils.device import as_float, constant
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


def _gabor_kernel(ksize: int, sigma: float, theta: float, lam: float, gamma: float = 0.3):
    half = ksize // 2
    ys, xs = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float32)
    xr = xs * np.cos(theta) + ys * np.sin(theta)
    yr = -xs * np.sin(theta) + ys * np.cos(theta)
    g = np.exp(-(xr ** 2 + gamma ** 2 * yr ** 2) / (2 * sigma ** 2)) * np.cos(2 * np.pi * xr / lam)
    g -= g.mean()
    n = np.sqrt((g ** 2).sum())
    return g / max(n, 1e-9)


@functools.lru_cache(maxsize=8)
def _bank(num_bands: int, num_rotations: int):
    """(n_filters, k, k) Gabor bank padded to a common kernel size (host
    float32, made once a configuration: read it, do not write it); scales
    follow the HMAX band schedule (two consecutive sizes per band)."""
    sizes = [7 + 2 * i for i in range(2 * num_bands)]
    kmax = sizes[-1]
    kernels = []
    meta = []  # (band, rot) per filter
    for b in range(num_bands):
        for s_idx in (2 * b, 2 * b + 1):
            k = sizes[s_idx]
            sigma = 0.0036 * k * k + 0.35 * k + 0.18
            lam = sigma / 0.8
            for r in range(num_rotations):
                theta = np.pi * r / num_rotations
                g = _gabor_kernel(k, sigma, theta, lam)
                pad = (kmax - k) // 2
                kernels.append(np.pad(g, pad))
                meta.append((b, r))
    return np.stack(kernels).astype(np.float32), meta, kmax


def bif_features(img: torch.Tensor, num_bands: int = 8, num_rotations: int = 12) -> torch.Tensor:
    """BIF descriptor of a (H, W) face crop (parity: cv::face::BIF::compute).

    Returns the concatenated per-band per-rotation grid standard deviations.
    Feature length = num_bands * num_rotations * 4 (2x2 pooling grid)."""
    f = as_float(img)
    bank, _, kmax = _bank(num_bands, num_rotations)
    f = (f - f.mean()) / torch.clamp(f.std(correction=0), min=1e-6)
    H, W = f.shape

    # one conv: input (1, 1, H, W), kernel (n_filters, 1, k, k)
    with f32_matmul_precision():
        resp = F.conv2d(f[None, None], constant(bank, f.device)[:, None], padding=kmax // 2)[0]  # (n_filters, H, W)
    resp = torch.abs(resp)

    n_rot = num_rotations
    feats = []
    for b in range(num_bands):
        base = b * 2 * n_rot
        # C1: max over the two scales of the band
        c1 = torch.maximum(resp[base:base + n_rot], resp[base + n_rot:base + 2 * n_rot])
        # grid std pooling (2x2)
        hh, ww = H // 2, W // 2
        cells = [c1[:, :hh, :ww], c1[:, :hh, ww:], c1[:, hh:, :ww], c1[:, hh:, ww:]]
        for cell in cells:
            feats.append(cell.std(dim=(1, 2), correction=0))
    return torch.cat(feats)
