"""Correlation-filter trackers: MOSSE and KCF (the port of
opencv_contrib_tpu/tracking/correlation.py).

Reference anchors: trackerMOSSE (legacy) and TrackerKCFImpl
(tracking/src/trackerKCF.cpp:74): FFT-domain ridge regression against a
Gaussian target response; KCF adds a Gaussian kernel on raw-pixel channels
(denseGaussKernel, :99,340) and circulant-shift training.

Everything is `torch.fft` math in complex64 on the image's device; a step
reads nothing back to the host (the peak is an on-device argmax, its value
a `torch.take`: indexing a CUDA tensor by a 0-dim tensor reads the index
on the host). The state is a NamedTuple of tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.utils.device import constant


def _vec(v, device) -> torch.Tensor:
    """A (y, x) pair or size as float32 on `device`: a tensor is moved, host
    values cross through pinned memory (no wait on the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return constant([float(a) for a in v], device)


def _linspace(start, stop, num: int, device=None) -> torch.Tensor:
    """`jnp.linspace` in float32: start (1 - s_i) + stop s_i with s_i = i
    (1 / (num - 1)) (XLA divides by the constant as a product with its
    reciprocal), the last point `stop` itself; `torch.linspace` parts from
    it by ulps. start, stop: numbers or 0-dim tensors."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) * (torch.ones((), device=device) / div)
    out = start * (1 - step) + stop * step
    end = stop.reshape(1) if isinstance(stop, torch.Tensor) else torch.full((1,), stop, device=device)
    return torch.cat([out, end.to(out.dtype)])


def _hann(n: int, device=None) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * torch.arange(n, dtype=torch.float32, device=device) / n)


def _window(shape, device=None) -> torch.Tensor:
    return _hann(shape[0], device)[:, None] * _hann(shape[1], device)[None, :]


def _gaussian_response(shape, sigma_factor: float = 0.1, device=None) -> torch.Tensor:
    H, W = shape
    sigma = np.float32(np.sqrt(np.float32(H * W))) * np.float32(sigma_factor)  # float32, as the twin's
    y = torch.arange(H, device=device) - H // 2
    x = torch.arange(W, device=device) - W // 2
    g = torch.exp(-0.5 * (y[:, None] ** 2 + x[None, :] ** 2) / float(sigma * sigma))
    return torch.roll(g, (-(H // 2), -(W // 2)), dims=(0, 1))


def _crop(img, center_yx, shape, scale=1.0):
    """A (shape * scale) window resized to `shape` as one bilinear gather
    (scale 1: the plain crop)."""
    H, W = shape
    dev = img.device
    y = center_yx[0] + (torch.arange(H, dtype=torch.float32, device=dev) - H / 2 + 0.5) * scale
    x = center_yx[1] + (torch.arange(W, dtype=torch.float32, device=dev) - W / 2 + 0.5) * scale
    return sample_bilinear(img, y[:, None] * torch.ones((1, W), device=dev), torch.ones((H, 1), device=dev) * x[None, :])


def _preprocess(patch):
    p = torch.log1p(patch - patch.min())
    p = (p - p.mean()) / (p.std(correction=0) + 1e-5)
    return p * _window(p.shape, p.device)


def _peak_offset(resp, H: int, W: int):
    """(flat argmax, dy, dx) of a response, the peak wrapped to [-H/2, H/2)."""
    idx = torch.argmax(resp)
    py, px = idx // W, idx % W
    dy = torch.where(py > H // 2, py - H, py).to(torch.float32)
    dx = torch.where(px > W // 2, px - W, px).to(torch.float32)
    return idx, dy, dx


class MosseState(NamedTuple):
    center: torch.Tensor  # (2,) y, x
    A: torch.Tensor  # filter numerator (complex); shape = window (H, W)
    B: torch.Tensor  # filter denominator (real)
    G: torch.Tensor  # target response FFT (complex)

    @property
    def size(self):
        return tuple(self.A.shape)


def mosse_init(img, center_yx, size=(64, 64), lr: float = 0.125) -> MosseState:
    center = _vec(center_yx, img.device)
    patch = _preprocess(_crop(img, center, size))
    F = torch.fft.fft2(patch)
    G = torch.fft.fft2(_gaussian_response(size, device=img.device))
    A = G * torch.conj(F)
    B = (F * torch.conj(F)).real + 1e-2
    return MosseState(center, A, B, G)


def mosse_update(state: MosseState, img, lr: float = 0.125):
    """One tracking step: locate the peak, re-train the filter online.
    Returns (new_state, psr), the PSR the reference's confidence."""
    patch = _preprocess(_crop(img, state.center, state.size))
    F = torch.fft.fft2(patch)
    Hf = state.A / state.B
    resp = torch.fft.ifft2(Hf * F).real
    H, W = state.size
    idx, dy, dx = _peak_offset(resp, H, W)
    center = state.center + torch.stack([dy, dx])

    # PSR confidence
    peak = torch.take(resp, idx)
    mean = (resp.sum() - peak) / (H * W - 1)
    std = torch.sqrt(torch.clamp(torch.mean((resp - mean) ** 2), min=1e-9))
    psr = (peak - mean) / std

    # online update at the NEW position
    patch2 = _preprocess(_crop(img, center, state.size))
    F2 = torch.fft.fft2(patch2)
    A = (1 - lr) * state.A + lr * state.G * torch.conj(F2)
    B = (1 - lr) * state.B + lr * ((F2 * torch.conj(F2)).real + 1e-2)
    return MosseState(center, A, B, state.G), psr


class KcfState(NamedTuple):
    center: torch.Tensor
    alpha_f: torch.Tensor  # dual coefficients (complex); shape = window (H, W)
    xf: torch.Tensor  # model appearance FFT (complex)
    G: torch.Tensor

    @property
    def size(self):
        return tuple(self.xf.shape)


def _gauss_kernel_corr(xf, zf, sigma: float):
    """Dense Gaussian kernel correlation in the Fourier domain
    (denseGaussKernel, trackerKCF.cpp:340); the conjugate on the model, so
    the peak moves with the target."""
    N = xf.shape[0] * xf.shape[1]
    xx = torch.sum(torch.abs(xf) ** 2) / N
    zz = torch.sum(torch.abs(zf) ** 2) / N
    xz = torch.fft.ifft2(torch.conj(xf) * zf).real
    d = torch.clamp(xx + zz - 2.0 * xz, min=0.0)
    return torch.exp(-d / (sigma * sigma * N))


def kcf_init(img, center_yx, size=(64, 64), sigma: float = 0.2, lam: float = 1e-4) -> KcfState:
    center = _vec(center_yx, img.device)
    patch = _preprocess(_crop(img, center, size))
    xf = torch.fft.fft2(patch)
    G = torch.fft.fft2(_gaussian_response(size, device=img.device))
    k = _gauss_kernel_corr(xf, xf, sigma)
    alpha_f = G / (torch.fft.fft2(k) + lam)
    return KcfState(center, alpha_f, xf, G)


def kcf_update(state: KcfState, img, sigma: float = 0.2, lam: float = 1e-4, lr: float = 0.075, scale=1.0):
    """One KCF step (with a DSST scale the window is sampled at size * scale).
    Returns (new_state, peak)."""
    patch = _preprocess(_crop(img, state.center, state.size, scale))
    zf = torch.fft.fft2(patch)
    k = _gauss_kernel_corr(state.xf, zf, sigma)
    resp = torch.fft.ifft2(state.alpha_f * torch.fft.fft2(k)).real
    H, W = state.size
    idx, dy, dx = _peak_offset(resp, H, W)
    # displacement measured in scale-normalized pixels -> image pixels
    center = state.center + torch.stack([dy, dx]) * scale

    patch2 = _preprocess(_crop(img, center, state.size, scale))
    xf_new = torch.fft.fft2(patch2)
    k2 = _gauss_kernel_corr(xf_new, xf_new, sigma)
    alpha_new = state.G / (torch.fft.fft2(k2) + lam)
    xf = (1 - lr) * state.xf + lr * xf_new
    alpha_f = (1 - lr) * state.alpha_f + lr * alpha_new
    peak = torch.take(resp, idx)
    return KcfState(center, alpha_f, xf, state.G), peak
