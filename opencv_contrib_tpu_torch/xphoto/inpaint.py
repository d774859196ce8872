"""Inpainting (the port of opencv_contrib_tpu/xphoto/inpaint.py; xphoto
inpaint's contract, reconstruct masked pixels from their surroundings):
fixed-iteration Jacobi diffusion with the known pixels pinned. The steps
queue on the image's device with no host sync between them."""

from __future__ import annotations

import torch


def inpaint_diffusion(img: torch.Tensor, mask: torch.Tensor, iters: int = 200) -> torch.Tensor:
    """img (H, W[, C]); mask True where pixels are MISSING."""
    img = img.to(torch.float32)
    m = mask.to(device=img.device, dtype=torch.bool)
    if img.ndim == 3:
        m = m[..., None]
    x = torch.where(m, 0.5, img)
    for _ in range(iters):
        nb = (torch.roll(x, 1, 0) + torch.roll(x, -1, 0) + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)) / 4.0
        x = torch.where(m, nb, img)
    return x
