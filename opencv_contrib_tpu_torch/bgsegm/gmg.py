"""GMG background subtraction (the port of opencv_contrib_tpu/bgsegm/gmg.py).

Reference anchor: bgsegm/src/bgfg_gmg.cpp (BackgroundSubtractorGMG,
bgsegm.hpp:125): per-pixel quantized color histograms accumulated over an
initialization window; posterior P(bg|color) thresholded with decision
smoothing.

The histogram bank is a (B, H, W) tensor updated by one-hot adds. The frame
count stays a 0-dim tensor on the device and the initialization window is a
`torch.where` of both updates, so a step reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GmgState(NamedTuple):
    hist: torch.Tensor  # (B, H, W) quantized color histogram
    frame_count: torch.Tensor  # () int32


def gmg_create(shape, n_bins: int = 16, device="cpu") -> GmgState:
    return GmgState(torch.zeros((n_bins,) + tuple(shape), device=device),
                    torch.zeros((), dtype=torch.int32, device=device))


def gmg_apply(state: GmgState, frame, init_frames: int = 20, decision_thresh: float = 0.8, lr: float = 0.025):
    """One GMG step. During the first init_frames everything is background
    and the histograms accumulate; afterwards a pixel is foreground when
    its color's histogram mass is low. Returns (state, fg_mask)."""
    B = state.hist.shape[0]
    q = torch.clamp((frame * B).to(torch.int32), 0, B - 1)
    onehot = (q[None] == torch.arange(B, device=frame.device)[:, None, None]).to(torch.float32)
    initializing = state.frame_count < init_frames
    # accumulate during init; slow exponential update after
    hist = torch.where(initializing, state.hist + onehot, (1 - lr) * state.hist + lr * onehot)
    total = torch.clamp(hist.sum(0), min=1e-6)
    # smooth over adjacent bins: colors near a quantization boundary split
    # their mass between two bins and must not read as foreground
    hist_s = hist + 0.5 * (torch.roll(hist, 1, 0) + torch.roll(hist, -1, 0))
    hist_s = hist_s / torch.clamp(hist_s.sum(0), min=1e-6) * total
    p_bg = (hist_s * onehot).sum(0) / total
    fg = (~initializing) & (p_bg < 1.0 - decision_thresh)
    return GmgState(hist, (state.frame_count + 1).to(torch.int32)), fg
