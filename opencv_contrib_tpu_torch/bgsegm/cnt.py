"""CNT background subtraction: per-pixel stability counters (the port of
opencv_contrib_tpu/bgsegm/cnt.py).

Parity: BackgroundSubtractorCNT (bgsegm.hpp:250) — a pixel becomes
background after being stable for minPixelStability frames; foreground when
it deviates from the learned stable value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CntState(NamedTuple):
    stable_val: torch.Tensor  # (H, W)
    stability: torch.Tensor  # (H, W) int32 counter
    bg_val: torch.Tensor  # (H, W)
    has_bg: torch.Tensor  # (H, W) bool


def cnt_create(shape, device="cpu") -> CntState:
    H, W = shape
    return CntState(
        stable_val=torch.zeros((H, W), device=device),
        stability=torch.zeros((H, W), dtype=torch.int32, device=device),
        bg_val=torch.zeros((H, W), device=device),
        has_bg=torch.zeros((H, W), dtype=torch.bool, device=device),
    )


def cnt_apply(state: CntState, frame: torch.Tensor, threshold: float = 0.04, min_stability: int = 15):
    """One frame -> (new_state, fg_mask)."""
    close = torch.abs(frame - state.stable_val) < threshold
    stability = torch.where(close, state.stability + 1, 0).to(torch.int32)
    stable_val = torch.where(close, state.stable_val, frame)
    promote = stability >= min_stability
    bg_val = torch.where(promote, stable_val, state.bg_val)
    has_bg = state.has_bg | promote
    fg = has_bg & (torch.abs(frame - bg_val) >= threshold)
    return CntState(stable_val, stability, bg_val, has_bg), fg
