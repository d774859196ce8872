"""PCT signatures and the SQFD distance (the port of
opencv_contrib_tpu/features/pct.py): features sampled at seeded random
positions, clustered by a fixed number of Lloyd k-means steps into a weighted
signature, and the Signature Quadratic Form Distance with a Gaussian
similarity.

The sample positions are host numpy draws from `default_rng(seed)`, as in the
JAX version, so both sample the same positions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import sample_bilinear_multi
from opencv_contrib_tpu_torch.utils.device import constant
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


class Signature(NamedTuple):
    centroids: torch.Tensor  # (K, D) feature-space centroids
    weights: torch.Tensor  # (K,) cluster masses (sum 1 over valid)
    valid: torch.Tensor  # (K,) bool


def _sample_features(img: torch.Tensor, n_samples: int, seed: int) -> torch.Tensor:
    """Feature points (N, 6): x, y, blurred intensity, local contrast,
    gradient magnitude and contrast x gradient, positions and intensities
    on [0, 1]."""
    H, W = img.shape
    g = img / (torch.abs(img).max() + 1e-9)
    rng = np.random.default_rng(seed)
    ys = constant(rng.uniform(2, H - 3, n_samples).astype(np.float32), img.device)
    xs = constant(rng.uniform(2, W - 3, n_samples).astype(np.float32), img.device)
    blur = filters.fast_gaussian_blur(g, 2.0)
    local_sq = filters.box_filter(g * g, 2)
    local_mean = filters.box_filter(g, 2)
    contrast = torch.sqrt(torch.clamp(local_sq - local_mean ** 2, min=0.0))
    gy, gx = filters.gradients(g)
    gmag = torch.sqrt(gx * gx + gy * gy)
    vals = sample_bilinear_multi(torch.stack([blur, contrast, gmag]), ys, xs)
    return torch.stack([xs / W, ys / H, vals[0], vals[1], vals[2], vals[1] * vals[2]], dim=1)


def _kmeans(feats: torch.Tensor, init: torch.Tensor, k: int, iters: int = 8):
    """`iters` Lloyd steps: assignment to the nearest centroid (ties to the
    lower index), update by a one-hot product; an empty cluster keeps its
    centroid. Returns (centroids, masses of the last step)."""
    cents, mass = init, None
    with f32_matmul_precision():
        for _ in range(iters):
            a = torch.argmin(((feats[:, None] - cents[None]) ** 2).sum(-1), 1)
            oh = F.one_hot(a, k).to(torch.float32)
            mass = oh.sum(0)
            newc = (oh.T @ feats) / torch.clamp(mass[:, None], min=1.0)
            cents = torch.where(mass[:, None] > 0, newc, cents)
    return cents, mass


def compute_signature(img: torch.Tensor, k: int = 8, n_samples: int = 512, iters: int = 8, seed: int = 0,
                      min_weight: float = 1e-3) -> Signature:
    """PCTSignatures::computeSignature: sample, cluster, weigh."""
    feats = _sample_features(img.to(torch.float32), n_samples, seed)
    init = feats[::max(n_samples // k, 1)][:k]
    cents, mass = _kmeans(feats, init, k, iters)
    w = mass / mass.sum()
    return Signature(centroids=cents, weights=w, valid=w > min_weight)


def sqfd(s1: Signature, s2: Signature, alpha: float = 2.0) -> torch.Tensor:
    """SQFD with sim(a, b) = exp(-alpha |a - b|^2): sqrt(w^T A w) for the
    concatenated weights w = [w1, -w2]."""
    c = torch.cat([s1.centroids, s2.centroids])
    w = torch.cat([s1.weights * s1.valid, -(s2.weights * s2.valid)])
    A = torch.exp(-alpha * ((c[:, None] - c[None]) ** 2).sum(-1))
    with f32_matmul_precision():
        q = w @ A @ w
    return torch.sqrt(torch.clamp(q, min=0.0))
