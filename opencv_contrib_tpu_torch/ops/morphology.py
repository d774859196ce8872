"""Morphology and non-max suppression: erode, dilate, opening, closing,
`nms2d` and a strided max pool (the port of
opencv_contrib_tpu/ops/morphology.py).

The JAX version takes `lax.reduce_window` with "SAME" padding, which pads
an even window asymmetrically: (size - 1) // 2 before and the rest after.
`F.max_pool2d` pads symmetrically, so the image is padded here explicitly
with -inf (+inf for the minimum) and pooled without padding. Maxima and
minima take no arithmetic, so both give the same bits."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _window_max(img: torch.Tensor, size: int) -> torch.Tensor:
    before = (size - 1) // 2
    after = size - 1 - before
    x = F.pad(img[None, None], (before, after, before, after), value=-math.inf)
    return F.max_pool2d(x, size, stride=1)[0, 0]


def dilate(img: torch.Tensor, size: int = 3, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        img = _window_max(img, size)
    return img


def erode(img: torch.Tensor, size: int = 3, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        img = -_window_max(-img, size)
    return img


def opening(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    return dilate(erode(img, size), size)


def closing(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    return erode(dilate(img, size), size)


def nms2d(response: torch.Tensor, size: int = 3) -> torch.Tensor:
    """True where response is the maximum of its size x size neighbourhood."""
    return response >= dilate(response, size)


def maxpool(img: torch.Tensor, stride: int) -> torch.Tensor:
    """Max over non-overlapping stride x stride windows; a remainder row or
    column is dropped ("VALID")."""
    return F.max_pool2d(img[None, None], stride, stride=stride)[0, 0]
