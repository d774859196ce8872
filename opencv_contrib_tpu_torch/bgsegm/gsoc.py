"""GSOC and LSBP background subtraction (the port of
opencv_contrib_tpu/bgsegm/gsoc.py).

Reference anchors: bgsegm/src/bgfg_gsoc.cpp
(BackgroundSubtractorGSOC: per-pixel sample bank with hit counters,
replace-weakest update, noise-adaptive thresholds;
BackgroundSubtractorLSBP: same banks over Local SVD Binary Pattern
descriptors compared by Hamming distance; bgsegm.hpp:325,337).

The per-pixel sample banks are a (K, H, W) tensor; matching, hit counting
and weakest-replacement are argmin reductions over the bank axis, one step
a frame with no per-pixel branching. The twin draws each frame's
replacement mask from a split key; here the state's `key` holds a
`torch.Generator` on the frame's device, and `_uniform` draws from it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops import filters


class GsocState(NamedTuple):
    samples: torch.Tensor  # (K, H, W) background sample bank
    hits: torch.Tensor  # (K, H, W) reliability counters
    key: torch.Generator  # the replacement draws


def gsoc_create(shape, n_samples: int = 20, key=None, device="cpu") -> GsocState:
    """Empty banks on `device`; `key` a torch.Generator on it (default: one
    seeded with 0)."""
    if key is None:
        key = torch.Generator(device).manual_seed(0)
    return GsocState(torch.zeros((n_samples,) + tuple(shape), device=device),
                     torch.zeros((n_samples,) + tuple(shape), device=device), key)


def _uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) float32 of `shape` from gen, on `device`."""
    return torch.rand(shape, generator=gen, device=device)


def _replace(key, frame, hits, replace_rate):
    """The twin's replacement mask: the weakest sample of each pixel, where
    this frame's draw falls below replace_rate. (K, H, W) bool."""
    K = hits.shape[0]
    weakest = torch.argmin(hits, dim=0)
    do = _uniform(key, frame.shape, frame.device) < replace_rate
    return (weakest[None] == torch.arange(K, device=frame.device)[:, None, None]) & do[None]


def gsoc_apply(state: GsocState, frame, dist_thresh: float = 0.08, replace_rate: float = 0.1):
    """One GSOC step. Returns (state, fg_mask)."""
    K = state.samples.shape[0]
    d = torch.abs(state.samples - frame[None])
    match = d < dist_thresh
    fg = ~match.any(dim=0)
    # reward the best-matching sample, decay the rest slightly
    best = torch.argmin(d, dim=0)
    onehot = best[None] == torch.arange(K, device=frame.device)[:, None, None]
    hits = state.hits + torch.where(onehot & match, 1.0, 0.0) - 0.01
    # replace the weakest sample with the current pixel (probabilistic,
    # and always where the pixel is foreground-stable)
    repl = _replace(state.key, frame, hits, replace_rate)
    samples = torch.where(repl, frame[None], state.samples)
    hits = torch.where(repl, 1.0, hits)
    return GsocState(samples, hits, state.key), fg


def lsbp_descriptor(img, radius: int = 2, tau: float = 0.02):
    """Local SVD Binary Pattern (bgfg_gsoc.cpp BackgroundSampleLSBP):
    binary comparisons of the local SVD-smoothed intensity against 8
    neighbors at `radius`. Returns (H, W) int32 8-bit codes."""
    # local structure value: ratio of local singular values is approximated
    # by the guided local mean (the reference precomputes an SVD map once)
    s = filters.box_filter(img, 1)
    H, W = img.shape
    p = F.pad(s[None, None], (radius,) * 4, mode="replicate")[0, 0]
    code = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    nbrs = [(-radius, -radius), (-radius, 0), (-radius, radius), (0, radius),
            (radius, radius), (radius, 0), (radius, -radius), (0, -radius)]
    for b, (dy, dx) in enumerate(nbrs):
        nb = p[radius + dy: radius + dy + H, radius + dx: radius + dx + W]
        code = code | ((torch.abs(nb - s) > tau).to(torch.int32) << b)
    return code


class LsbpState(NamedTuple):
    gsoc: GsocState  # intensity banks
    desc: torch.Tensor  # (K, H, W) int32 LSBP code bank


def lsbp_create(shape, n_samples: int = 20, key=None, device="cpu") -> LsbpState:
    return LsbpState(gsoc_create(shape, n_samples, key, device),
                     torch.zeros((n_samples,) + tuple(shape), dtype=torch.int32, device=device))


def _popcount8(x):
    c = x - ((x >> 1) & 0x55)
    c = (c & 0x33) + ((c >> 2) & 0x33)
    return (c + (c >> 4)) & 0x0F


def lsbp_apply(state: LsbpState, frame, dist_thresh: float = 0.08, hamming_thresh: int = 3,
               replace_rate: float = 0.1):
    """One LSBP step: a pixel is background if some bank sample matches in
    BOTH intensity and LSBP Hamming distance. Returns (state, fg_mask)."""
    g = state.gsoc
    K = g.samples.shape[0]
    code = lsbp_descriptor(frame)
    d_int = torch.abs(g.samples - frame[None])
    d_ham = _popcount8(state.desc ^ code[None])
    match = (d_int < dist_thresh) & (d_ham <= hamming_thresh)
    fg = ~match.any(dim=0)
    score = d_int + 0.05 * d_ham
    best = torch.argmin(score, dim=0)
    onehot = best[None] == torch.arange(K, device=frame.device)[:, None, None]
    hits = g.hits + torch.where(onehot & match, 1.0, 0.0) - 0.01
    repl = _replace(g.key, frame, hits, replace_rate)
    samples = torch.where(repl, frame[None], g.samples)
    desc = torch.where(repl, code[None], state.desc)
    hits = torch.where(repl, 1.0, hits)
    return LsbpState(GsocState(samples, hits, g.key), desc), fg
