"""Retina model: photoreceptor adaptation + parvo (detail) and magno
(motion/transient) channels (the port of
opencv_contrib_tpu/bioinspired/retina.py). `Retina` keeps its state, a
RetinaState of tensors on its device, between `run` calls."""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.utils.device import to_device


class RetinaState(NamedTuple):
    adapted: torch.Tensor  # photoreceptor temporal state
    horizontal: torch.Tensor  # horizontal-cell state (low-pass surround)
    magno_prev: torch.Tensor  # previous parvo output (for transients)
    magno_lp: torch.Tensor  # magno temporal low-pass


class Retina:
    """run(frame) -> (parvo, magno); getParvo/getMagno-style channels. The
    state lives on `device`; frames are moved there as float32."""

    def __init__(self, shape, photoreceptor_sigma: float = 1.0, horizontal_sigma: float = 3.0,
                 temporal_tau: float = 0.5, magno_tau: float = 0.3, compression: float = 0.3, device="cpu"):
        self.shape = shape
        self.ps = photoreceptor_sigma
        self.hs = horizontal_sigma
        self.tau = temporal_tau
        self.mtau = magno_tau
        self.compression = compression
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        z = torch.zeros(tuple(self.shape), device=self.device)
        self.state = RetinaState(z, z, z, z)

    def run(self, frame):
        self.state, parvo, magno = _retina_step(
            self.state, to_device(frame, self.device), self.ps, self.hs, self.tau, self.mtau, self.compression)
        return parvo, magno


def _retina_step(state: RetinaState, frame, ps, hs, tau, mtau, compression):
    # photoreceptor: divisive local luminance normalization (the
    # light-adaptation role of the Naka-Rushton stage) + temporal low-pass
    local_mean = filters.gaussian_blur(frame, ps * 4.0)
    adapted_now = frame / (local_mean + compression)
    adapted = tau * state.adapted + (1 - tau) * adapted_now

    # OPL: center (photoreceptor blur) minus surround (horizontal cells)
    center = filters.gaussian_blur(adapted, ps)
    horizontal = tau * state.horizontal + (1 - tau) * filters.gaussian_blur(adapted, hs)
    parvo = center - horizontal  # bipolar cells ON-OFF detail channel

    # magno: transient (temporal derivative) of the parvo signal, amplified
    # and low-passed spatially
    transient = torch.abs(parvo - state.magno_prev)
    magno_lp = mtau * state.magno_lp + (1 - mtau) * transient
    magno = filters.gaussian_blur(magno_lp, hs)

    new_state = RetinaState(adapted=adapted, horizontal=horizontal, magno_prev=parvo, magno_lp=magno_lp)
    return new_state, parvo, magno
