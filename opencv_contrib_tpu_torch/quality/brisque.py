"""BRISQUE natural-scene statistics (the port of
opencv_contrib_tpu/quality/brisque.py; quality/src/quality_brisque.cpp's
feature stage): MSCN coefficients and AGGD fits over 4 pairwise products at
2 scales -> a 36-dim feature vector.

The MSCN map and the pairwise products go through the grid_transform
kernel and the moments of each fit through one grid_reduce_sums launch (10
a frame at two scales); the fits' scalar arithmetic stays on the device. The
shape parameter alpha is the point of a 980-point grid whose gamma-function
ratio is nearest the moment ratio; the ratio tables are computed once per
device, in float32 on the CPU."""

from __future__ import annotations

import functools

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.cuda import reduce, transform
from opencv_contrib_tpu_torch.ops.image import resize

SHIFTS = ((0, 1), (1, 0), (1, 1), (1, -1))


def _tables(device) -> tuple:
    return _tables_on(str(device))


@functools.lru_cache(maxsize=None)
def _tables_on(device: str) -> tuple:
    """(gam, the GGD ratio, the reciprocal AGGD ratio) on `device`: gam is
    jnp.arange(0.2, 10.0, 0.01) (numpy's float32 arange)."""
    gam = torch.from_numpy(np.arange(0.2, 10.0, 0.01, dtype=np.float32))
    lg = torch.lgamma
    ggd = torch.exp(lg(1.0 / gam) + lg(3.0 / gam) - 2.0 * lg(2.0 / gam))
    aggd = torch.exp(lg(2.0 / gam) * 2 - lg(1.0 / gam) - lg(3.0 / gam))
    rr = 1.0 / torch.clamp(aggd, min=1e-12)
    return tuple(t.to(device) for t in (gam, ggd, rr))


def mscn_coefficients(img: torch.Tensor, sigma: float = 7.0 / 6.0) -> torch.Tensor:
    """Mean-subtracted contrast-normalized coefficients of (H, W)."""
    mu = filters.gaussian_blur(img, sigma)
    s2 = filters.gaussian_blur(img * img, sigma)
    return transform.grid_transform(transform.mscn(), img, mu, s2)


def _ggd_params(x: torch.Tensor):
    """Moment-matched generalized-gaussian (alpha, sigma)."""
    gam, ggd, _ = _tables(x.device)
    sigma2, E = reduce.grid_reduce_sums(transform.ggd_moments(), x, div=float(x.numel()))
    rho = sigma2 / torch.clamp(E * E, min=1e-12)
    alpha = gam[torch.argmin(torch.abs(ggd - rho))]
    return alpha, torch.sqrt(sigma2)


def _aggd_params(x: torch.Tensor):
    """Asymmetric GGD fit -> (alpha, mean, sigma_l, sigma_r)."""
    gam, _, rr = _tables(x.device)
    n = float(x.numel())
    s_neg, s_pos, s_neg_sq, s_pos_sq, E, sq_mean = reduce.grid_reduce_sums(
        transform.aggd_moments(), x, div=(1.0, 1.0, 1.0, 1.0, n, n))
    nl = torch.clamp(s_neg, min=1.0)
    nr = torch.clamp(s_pos, min=1.0)
    sigma_l = torch.sqrt(s_neg_sq / nl)
    sigma_r = torch.sqrt(s_pos_sq / nr)
    gamma_hat = sigma_l / torch.clamp(sigma_r, min=1e-12)
    rho = sq_mean / torch.clamp(E * E, min=1e-12)
    rhat = rho * (gamma_hat ** 3 + 1) * (gamma_hat + 1) / torch.clamp((gamma_hat ** 2 + 1) ** 2, min=1e-12)
    alpha = gam[torch.argmin(torch.abs(rr - rhat))]
    const = torch.exp(torch.lgamma(1.0 / alpha) - torch.lgamma(2.0 / alpha))
    return alpha, (sigma_r - sigma_l) * const, sigma_l, sigma_r


def brisque_features(img: torch.Tensor) -> torch.Tensor:
    """36-dim BRISQUE feature vector of (H, W) (18 per scale x 2 scales)."""
    feats = []
    x = img.to(torch.float32)
    for scale in range(2):
        m = mscn_coefficients(x)
        a, s = _ggd_params(m)
        feats += [a, s * s]
        for shift in SHIFTS:
            prod = transform.grid_transform(transform.mul(), m, torch.roll(m, shift, dims=(0, 1)))
            al, mu, sl, sr = _aggd_params(prod)
            feats += [al, mu, sl * sl, sr * sr]
        if scale == 0:
            x = resize(x, (x.shape[0] // 2, x.shape[1] // 2))
    return torch.stack(feats)


def no_reference_score(img: torch.Tensor, sigma_ref: float = 0.04) -> torch.Tensor:
    """No-reference quality proxy in [0, 100] (higher = worse) from the
    MSCN energy, the stand-in for the reference's trained SVM head."""
    _, s = _ggd_params(mscn_coefficients(img.to(torch.float32)))
    dev = torch.abs(torch.log(torch.clamp(s, min=1e-5) / sigma_ref))
    return torch.clamp(25.0 * dev, 0.0, 100.0)
