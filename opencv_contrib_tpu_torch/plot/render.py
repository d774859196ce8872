"""Rasterize a 2D curve into an image (Plot2d::render contract; the port of
opencv_contrib_tpu/plot/render.py)."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.tracking.correlation import _linspace
from opencv_contrib_tpu_torch.utils.device import as_float


def plot2d(x, y, shape=(240, 320), line_value: float = 1.0, bg_value: float = 0.0, margin: int = 10,
           samples_per_seg: int = 8) -> torch.Tensor:
    """Render curve (x, y) -> (H, W) image with the curve drawn bright, where
    x lies (host data on the CPU).

    Vectorized: segments are densified by linear interpolation (the twin's
    `jnp.linspace`) and splatted with a scatter-max (`scatter_reduce`
    "amax", the same on every order of the writes)."""
    x = as_float(x)
    y = as_float(y).to(x.device)
    H, W = shape
    xmin, xmax = x.min(), x.max()
    ymin, ymax = y.min(), y.max()
    sx = torch.full_like(xmin, W - 1 - 2 * margin) / torch.clamp(xmax - xmin, min=1e-9)
    sy = torch.full_like(ymin, H - 1 - 2 * margin) / torch.clamp(ymax - ymin, min=1e-9)
    px = (x - xmin) * sx + margin
    py = (H - 1 - margin) - (y - ymin) * sy  # y up

    # densify segments
    t = _linspace(0.0, 1.0, samples_per_seg, x.device)[None, :]
    qx = px[:-1, None] * (1 - t) + px[1:, None] * t
    qy = py[:-1, None] * (1 - t) + py[1:, None] * t
    xi = torch.clamp(torch.round(qx).to(torch.int64), 0, W - 1).reshape(-1)
    yi = torch.clamp(torch.round(qy).to(torch.int64), 0, H - 1).reshape(-1)
    img = torch.full((H * W,), bg_value, dtype=torch.float32, device=x.device)
    src = torch.full(xi.shape, line_value, dtype=torch.float32, device=x.device)
    return img.scatter_reduce(0, yi * W + xi, src, "amax").reshape(H, W)
