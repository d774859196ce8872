"""Artistic filters (the port of opencv_contrib_tpu/xphoto/artistic.py;
xphoto oilPainting, xphoto/src/oilpainting.cpp): each output pixel takes
the most frequent intensity bin of its neighbourhood, through box-filtered
votes of every bin (`ops.filters.box_filter` over the bins' stack), not a
histogram a pixel."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops import filters


def oil_painting(img: torch.Tensor, radius: int = 3, bins: int = 16) -> torch.Tensor:
    """Grayscale (H, W) in [0,1]."""
    img = img.to(torch.float32)
    q = torch.clamp((img * bins).to(torch.int32), 0, bins - 1)
    b = torch.arange(bins, dtype=torch.int32, device=img.device)
    hit = q[..., None] == b  # (H, W, B)
    votes = filters.box_filter(hit.to(torch.float32), radius)
    sums = filters.box_filter(torch.where(hit, img[..., None], 0.0), radius)
    best = torch.argmax(votes, dim=-1, keepdim=True)
    cnt = torch.gather(votes, -1, best)[..., 0]
    val = torch.gather(sums, -1, best)[..., 0]
    return val / torch.clamp(cnt, min=1e-9)
