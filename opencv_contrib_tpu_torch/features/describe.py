"""SURF-class 64-d descriptor — the port of
opencv_contrib_tpu/features/describe.py::surf_describe."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import sample_bilinear_multi


def surf_describe(img: torch.Tensor, kps: Keypoints, patch_cells: int = 4, cell_samples: int = 5) -> torch.Tensor:
    """Rotated 20s patch -> patch_cells^2 cells, each accumulating
    Gaussian-weighted (sum dx, sum|dx|, sum dy, sum|dy|) of rotated
    gradients. Returns (K, patch_cells^2 * 4), L2-normalized, zero rows for
    invalid keypoints."""
    g = filters.gaussian_blur(img, 1.0)
    gy, gx = filters.gradients(g)

    n = patch_cells * cell_samples  # samples across the patch
    u = (torch.arange(n, dtype=torch.float32, device=img.device) - n / 2 + 0.5) * (20.0 / n)
    gyy, gxx = torch.meshgrid(u, u, indexing="ij")  # (n, n)
    w = torch.exp(-(gxx ** 2 + gyy ** 2) / (2 * (3.3 * 2.0) ** 2))

    c = torch.cos(kps.angle)[:, None, None]
    s = torch.sin(kps.angle)[:, None, None]
    sc = kps.scale[:, None, None]

    px = kps.x[:, None, None] + sc * (c * gxx[None] - s * gyy[None])
    py = kps.y[:, None, None] + sc * (s * gxx[None] + c * gyy[None])

    sgx, sgy = sample_bilinear_multi(torch.stack([gx, gy]), py, px)
    rx = (c * sgx + s * sgy) * w[None]
    ry = (-s * sgx + c * sgy) * w[None]

    K = kps.capacity
    cells_x = rx.reshape(K, patch_cells, cell_samples, patch_cells, cell_samples)
    cells_y = ry.reshape(K, patch_cells, cell_samples, patch_cells, cell_samples)
    f1 = cells_x.sum(dim=(2, 4))
    f2 = torch.abs(cells_x).sum(dim=(2, 4))
    f3 = cells_y.sum(dim=(2, 4))
    f4 = torch.abs(cells_y).sum(dim=(2, 4))
    desc = torch.stack([f1, f2, f3, f4], dim=-1).reshape(K, -1)
    desc = desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-12)
    return desc * kps.valid[:, None]
