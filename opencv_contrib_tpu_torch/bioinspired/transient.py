"""Transient areas segmentation (bioinspired's motion-event detector; the
port of opencv_contrib_tpu/bioinspired/transient.py).

Reference anchor: bioinspired/src/transientareassegmentationmodule.cpp
(TransientAreasSegmentationModule::run — three low-passed context maps of
the magno motion energy: local, neighborhood, global; a pixel is
'transient' when its local energy exceeds the context by a threshold).

The neighborhood context is `fast_gaussian_blur` at sigma 6: three box
passes of summed-area tables, each one launch of the integral kernel on the
card, so a step launches it three times.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.ops import filters


class TransientState(NamedTuple):
    local_e: torch.Tensor  # temporally smoothed local motion energy
    nbhd_e: torch.Tensor  # neighborhood context
    global_e: torch.Tensor  # wide context


def transient_create(shape, device="cpu") -> TransientState:
    z = torch.zeros(tuple(shape), device=device)
    return TransientState(z, z, z)


def transient_run(state: TransientState, magno_out, local_sigma: float = 1.5, nbhd_sigma: float = 6.0,
                  temporal: float = 0.5, context_gain: float = 1.15):
    """One step: returns (state, segmentation mask). magno_out is the
    retina's magnocellular (motion) channel for the frame."""
    e = torch.abs(magno_out)
    loc = filters.gaussian_blur(e, local_sigma)
    nbh = filters.fast_gaussian_blur(e, nbhd_sigma)
    glo = e.mean().expand(e.shape)
    local_e = (1 - temporal) * state.local_e + temporal * loc
    nbhd_e = (1 - temporal) * state.nbhd_e + temporal * nbh
    global_e = (1 - temporal) * state.global_e + temporal * glo
    # context = blend of neighborhood and global energy: the pure
    # center-surround comparison goes blind deep inside LARGE transient
    # regions (local ~ nbhd there); the global term keeps them segmented
    seg = local_e > context_gain * (0.5 * nbhd_e + 0.5 * global_e)
    return TransientState(local_e, nbhd_e, global_e), seg
