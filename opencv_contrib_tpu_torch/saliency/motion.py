"""Motion saliency: a per-pixel temporal background model (the port of
opencv_contrib_tpu/saliency/motion.py; MotionSaliencyBinWangApr2014's
contract as a running mean / variance model: salient = statistically
unlikely pixels). The state stays on the device, its frame count a 0-d
tensor, so a step reads nothing back to the host."""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.utils.device import as_float


class MotionSaliency(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    frames: torch.Tensor  # 0-d count


def motion_create(shape, device="cpu") -> MotionSaliency:
    return MotionSaliency(torch.zeros(shape, device=device), torch.full(shape, 0.01, device=device),
                          torch.zeros((), device=device))


def motion_apply(state: MotionSaliency, frame, lr: float = 0.05, k: float = 3.0):
    frame = as_float(frame)
    d2 = (frame - state.mean) ** 2
    sal = d2 > k * k * state.var
    # warm start: a running average while few frames were seen, an EMA after
    lr_eff = torch.clamp(1.0 / (state.frames + 1.0), min=lr)
    mean = (1 - lr_eff) * state.mean + lr_eff * frame
    # the first frame's d2 is its distance to the zero mean, not noise: keep the prior variance
    var_upd = torch.clamp((1 - lr_eff) * state.var + lr_eff * d2, min=1e-4)
    var = torch.where(state.frames < 1, state.var, var_upd)
    ready = state.frames > 5  # warm-up: nothing is salient for the first frames
    return MotionSaliency(mean, var, state.frames + 1), sal & ready
