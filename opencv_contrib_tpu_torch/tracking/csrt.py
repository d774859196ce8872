"""CSRT: discriminative correlation filter with channel and spatial
reliability (Lukezic et al. CVPR'17); the port of
opencv_contrib_tpu/tracking/csrt.py.

Reference anchors: tracking/src/trackerCSRT.cpp:28 (TrackerCSRTImpl),
update_csr_filter (:131, constrained-filter ADMM), get_features (:173),
estimate_new_position (:52, weighted per-channel response).

A step is multi-channel features, the spatial-reliability mask, a fixed
4-step ADMM solve of the constrained filter (all channels in one batched
`fft2`, the twin's vmap) and channel-weighted localization, on the image's
device with no host read.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.ops.filters import gradients
from opencv_contrib_tpu_torch.tracking.correlation import _crop, _gaussian_response, _vec, _window

N_ORIENT = 8  # HOG-lite orientation channels
N_CHANNELS = N_ORIENT + 1  # + normalized grayscale


def _features(patch):
    """HOG-lite channels (soft orientation binning of the gradient
    magnitude) plus a windowed grayscale channel: (C, H, W). Each pixel's
    two bins are distinct, so each channel holds its one value there: the
    twin's two scatter-adds into zeros, as two selects."""
    gy, gx = gradients(patch)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)  # [-pi, pi]
    bin_f = (ang + math.pi) / (2 * math.pi) * N_ORIENT
    lo = torch.floor(bin_f)
    w_hi = bin_f - lo
    lo = lo.to(torch.int64) % N_ORIENT
    hi = (lo + 1) % N_ORIENT
    k = torch.arange(N_ORIENT, device=patch.device)[:, None, None]
    zero = torch.zeros((), dtype=patch.dtype, device=patch.device)
    ch = torch.where(lo[None] == k, mag * (1 - w_hi), zero) + torch.where(hi[None] == k, mag * w_hi, zero)
    gray = (patch - patch.mean()) / (patch.std(correction=0) + 1e-5)
    feats = torch.cat([ch, gray[None]], dim=0)
    return feats * _window(patch.shape, patch.device)[None]


def _spatial_reliability(patch, target_hw, size):
    """Foreground/background likelihood mask: a gray histogram likelihood
    ratio times an Epanechnikov prior over twice the target, normalized to
    [~0, 1]; the prior alone where the segmentation collapses."""
    H, W = size
    th, tw = target_hw
    dev = patch.device
    yy = (torch.arange(H, device=dev) - H / 2 + 0.5) / (th / 2)
    xx = (torch.arange(W, device=dev) - W / 2 + 0.5) / (tw / 2)
    r2 = yy[:, None] ** 2 + xx[None, :] ** 2
    prior = torch.clamp(1.0 - r2 / 4.0, min=0.0)
    fg_region = (r2 <= 1.0).to(patch.dtype)

    nbins = 16
    q = torch.clamp((patch - patch.min()) / (patch.max() - patch.min() + 1e-6) * nbins, 0, nbins - 1e-3)
    qi = q.to(torch.int64)
    onehot = torch.nn.functional.one_hot(qi, nbins).to(patch.dtype)
    hist_fg = (onehot * fg_region[..., None]).sum((0, 1)) + 1.0
    hist_bg = (onehot * (1 - fg_region)[..., None]).sum((0, 1)) + 1.0
    hist_fg = hist_fg / hist_fg.sum()
    hist_bg = hist_bg / hist_bg.sum()
    lik = (onehot * (hist_fg / (hist_fg + hist_bg))[None, None, :]).sum(-1)
    m = lik * prior
    m = m / (m.max() + 1e-6)
    return torch.where(m.sum() > 0.1 * fg_region.sum(), m, prior / (prior.max() + 1e-6))


def _admm_filter(feat_f, G, mask, lam: float = 0.01, iters: int = 4, mu0: float = 5.0):
    """Constrained ridge filter by ADMM (update_csr_filter,
    trackerCSRT.cpp:131), every channel at once: h = argmin ||f*h - g||^2 +
    lam ||h||^2 subject to h = mask . h, a fixed number of steps."""
    Sxy = torch.conj(feat_f) * G[None]
    Sxx = (feat_f * torch.conj(feat_f)).real
    h_f = Sxy / (Sxx + lam)
    l_f = torch.zeros_like(h_f)
    mu = mu0
    hm = h_f
    for _ in range(iters):
        hm_f = (Sxy + mu * hm - l_f) / (Sxx + lam + mu)
        h_spatial = torch.fft.ifft2(hm_f + l_f / mu).real * mask
        hm = torch.fft.fft2(h_spatial)
        l_f = l_f + mu * (hm_f - hm)
        mu = mu * 2.0
    return hm


class CsrtState(NamedTuple):
    center: torch.Tensor  # (2,) y, x
    target_hw: torch.Tensor  # (2,) tracked box size (float, for output)
    h_f: torch.Tensor  # (C, H, W) complex filter
    chan_w: torch.Tensor  # (C,) channel reliability weights
    G: torch.Tensor


def _learn(img, center, target_hw, size, G, scale=1.0):
    patch = _crop(img, center, size, scale)
    feats = _features(patch)
    mask = _spatial_reliability(patch, target_hw, size)
    h_f = _admm_filter(torch.fft.fft2(feats), G, mask)
    # channel reliability: each channel's max response on the training patch
    resp = torch.fft.ifft2(h_f * torch.fft.fft2(feats)).real
    w = torch.clamp(resp.amax(dim=(1, 2)), min=1e-6)
    return h_f, w / w.sum()


def csrt_init(img, center_yx, target_hw=(32, 32), size=(64, 64)) -> CsrtState:
    center = _vec(center_yx, img.device)
    G = torch.fft.fft2(_gaussian_response(size, sigma_factor=1.0 / 16.0, device=img.device))
    thw = tuple(float(v) for v in target_hw)
    h_f, w = _learn(img, center, thw, size, G)
    return CsrtState(center, _vec(thw, img.device), h_f, w, G)


def csrt_update(state: CsrtState, img, lr: float = 0.02, scale=1.0):
    """One CSRT step: channel-weighted localization with a parabolic
    sub-pixel peak, then the constrained filter re-learnt at the new
    position; with a scale the window is sampled at size * scale and tracked
    in scale-normalized space. Returns (new_state, peak_response)."""
    size = tuple(state.h_f.shape[1:])
    H, W = size
    patch = _crop(img, state.center, size, scale)
    feats = _features(patch)
    resp_c = torch.fft.ifft2(state.h_f * torch.fft.fft2(feats)).real
    resp = (resp_c * state.chan_w[:, None, None]).sum(0)
    idx = torch.argmax(resp)
    py, px = idx // W, idx % W
    r0 = torch.take(resp, idx)
    ry1 = torch.take(resp, (py + 1) % H * W + px)
    rym = torch.take(resp, (py - 1) % H * W + px)
    rx1 = torch.take(resp, py * W + (px + 1) % W)
    rxm = torch.take(resp, py * W + (px - 1) % W)
    tiny = torch.full((), 1e-9, device=resp.device)
    sub_y = 0.5 * (rym - ry1) / torch.where(torch.abs(rym - 2 * r0 + ry1) > 1e-9, rym - 2 * r0 + ry1, tiny)
    sub_x = 0.5 * (rxm - rx1) / torch.where(torch.abs(rxm - 2 * r0 + rx1) > 1e-9, rxm - 2 * r0 + rx1, tiny)
    sub_y = torch.clamp(sub_y, -0.5, 0.5)
    sub_x = torch.clamp(sub_x, -0.5, 0.5)
    dy = torch.where(py > H // 2, py - H, py).to(torch.float32) + sub_y
    dx = torch.where(px > W // 2, px - W, px).to(torch.float32) + sub_x
    center = state.center + torch.stack([dy, dx]) * scale

    target_hw = (state.target_hw[0], state.target_hw[1])
    h_new, w_new = _learn(img, center, target_hw, size, state.G, scale)
    h_f = (1 - lr) * state.h_f + lr * h_new
    chan_w = (1 - lr) * state.chan_w + lr * w_new
    return CsrtState(center, state.target_hw, h_f, chan_w, state.G), r0
