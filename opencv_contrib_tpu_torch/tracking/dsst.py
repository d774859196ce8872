"""DSST scale estimation (Danelljan et al. BMVC'14), the scale filter the
reference couples to CSRT (trackerCSRT.cpp:131); the port of
opencv_contrib_tpu/tracking/dsst.py.

A 1-D correlation filter over S scale samples: S patches cropped at scales
a^s around the tracked centre, resized to one template, flattened, and
correlated along the scale axis with a learned MOSSE-style filter. The S
crops are one batched bilinear gather; the scale correlation a length-S
`torch.fft.fft`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.tracking.correlation import _vec

N_SCALES = 17
SCALE_STEP = 1.03
TEMPLATE = (24, 24)


def _scale_factors(device=None):
    s = torch.arange(N_SCALES, dtype=torch.float32, device=device) - (N_SCALES - 1) / 2
    return torch.pow(SCALE_STEP, s)  # (S,)


def _crop_scaled(img, center_yx, base_hw, scales):
    """(S, th, tw): a (base_hw * scale) window at each scale, resized to
    TEMPLATE through the sampling grid itself (one bilinear gather)."""
    th, tw = TEMPLATE
    dev = img.device
    H = base_hw[0] * scales  # (S,)
    W = base_hw[1] * scales
    y = center_yx[0] + (torch.arange(th, dtype=torch.float32, device=dev) / th - 0.5)[None, :] * H[:, None] + 0.5
    x = center_yx[1] + (torch.arange(tw, dtype=torch.float32, device=dev) / tw - 0.5)[None, :] * W[:, None] + 0.5
    return sample_bilinear(img, y[:, :, None] * torch.ones((1, 1, tw), device=dev),
                           torch.ones((1, th, 1), device=dev) * x[:, None, :])


def _scale_features(img, center, base_hw):
    """(S, D) feature rows: crops blurred by a separable 5-tap binomial
    twice (rolled adds), each normalized."""
    patches = _crop_scaled(img, center, base_hw, _scale_factors(img.device))

    def blur1(p, axis):
        return (torch.roll(p, -2, axis) + 4 * torch.roll(p, -1, axis) + 6 * p
                + 4 * torch.roll(p, 1, axis) + torch.roll(p, 2, axis)) / 16.0

    for _ in range(2):
        patches = blur1(blur1(patches, 1), 2)
    mu = patches.mean(dim=(1, 2), keepdim=True)
    sd = patches.std(dim=(1, 2), keepdim=True, correction=0) + 1e-5
    norm = (patches - mu) / sd
    return norm.reshape(N_SCALES, -1)  # (S, D)


def _hann_s(device=None):
    return 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(N_SCALES, device=device) / (N_SCALES - 1))


def _gaussian_scale_response(sigma: float = 1.2, device=None):
    s = torch.arange(N_SCALES, dtype=torch.float32, device=device) - (N_SCALES - 1) / 2
    g = torch.exp(-0.5 * (s / sigma) ** 2)
    return torch.roll(g, -(N_SCALES - 1) // 2)  # peak at index 0


class DsstState(NamedTuple):
    A: torch.Tensor  # (S, D) complex numerator
    B: torch.Tensor  # (S,) real denominator
    scale: torch.Tensor  # () current scale multiplier vs the initial box


def _filter(feats):
    F = torch.fft.fft(feats * _hann_s(feats.device)[:, None], dim=0)
    G = torch.fft.fft(_gaussian_scale_response(device=feats.device))
    return F, torch.conj(F) * G[:, None], (F * torch.conj(F)).real.sum(dim=1)


def dsst_init(img, center_yx, base_hw) -> DsstState:
    dev = img.device
    _, A, B = _filter(_scale_features(img, _vec(center_yx, dev), _vec(base_hw, dev)))
    return DsstState(A, B, torch.ones((), device=dev))


def dsst_update(state: DsstState, img, center_yx, base_hw, lr: float = 0.025, lam: float = 1e-2):
    """Estimate the scale at the (already translated) centre and update the
    filter. Returns (new_state, scale_multiplier)."""
    dev = img.device
    center = _vec(center_yx, dev)
    base = _vec(base_hw, dev)
    F, _, _ = _filter(_scale_features(img, center, base * state.scale))
    resp = torch.fft.ifft(torch.sum(state.A * F, dim=1) / (state.B + lam)).real  # (S,)
    idx = torch.argmax(resp)
    step = torch.where(idx > N_SCALES // 2, idx - N_SCALES, idx).to(torch.float32)
    new_scale = torch.clamp(state.scale * torch.pow(SCALE_STEP, step), 0.2, 5.0)

    # re-extract at the accepted scale and update the filter
    _, A_new, B_new = _filter(_scale_features(img, center, base * new_scale))
    A = (1 - lr) * state.A + lr * A_new
    B = (1 - lr) * state.B + lr * B_new
    return DsstState(A, B, new_scale), new_scale


# ---------------------------------------------------------------------------
# scale-adaptive composite trackers (translation filter + DSST scale filter,
# the reference CSRT's coupling in trackerCSRT.cpp:131 + DSST scale module)

class ScaledState(NamedTuple):
    base: object  # CsrtState | KcfState (translation filter state)
    dsst: DsstState
    base_hw: torch.Tensor  # (2,) initial box size; current = base_hw * dsst.scale


def csrt_scale_init(img, center_yx, target_hw=(32, 32), size=(64, 64)) -> ScaledState:
    from opencv_contrib_tpu_torch.tracking import csrt as csrt_mod

    base = csrt_mod.csrt_init(img, center_yx, target_hw=target_hw, size=size)
    d = dsst_init(img, center_yx, target_hw)
    return ScaledState(base, d, _vec(target_hw, img.device))


def csrt_scale_update(state: ScaledState, img):
    """Returns (new_state, (center, box_hw), peak). The translation filter
    runs in scale-normalized space (window sampled at size * scale)."""
    from opencv_contrib_tpu_torch.tracking import csrt as csrt_mod

    base, peak = csrt_mod.csrt_update(state.base, img, scale=state.dsst.scale)
    d, scale = dsst_update(state.dsst, img, base.center, state.base_hw)
    return ScaledState(base, d, state.base_hw), (base.center, state.base_hw * scale), peak


def kcf_scale_init(img, center_yx, target_hw=(32, 32), size=(64, 64)) -> ScaledState:
    from opencv_contrib_tpu_torch.tracking import correlation

    base = correlation.kcf_init(img, center_yx, size=size)
    d = dsst_init(img, center_yx, target_hw)
    return ScaledState(base, d, _vec(target_hw, img.device))


def kcf_scale_update(state: ScaledState, img):
    from opencv_contrib_tpu_torch.tracking import correlation

    base, peak = correlation.kcf_update(state.base, img, scale=state.dsst.scale)
    d, scale = dsst_update(state.dsst, img, base.center, state.base_hw)
    return ScaledState(base, d, state.base_hw), (base.center, state.base_hw * scale), peak

