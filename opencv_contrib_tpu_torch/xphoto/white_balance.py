"""White balance (the port of opencv_contrib_tpu/xphoto/white_balance.py:
xphoto SimpleWB and GrayworldWB)."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops.cuda import reduce, transform


def simple_wb(img: torch.Tensor, p: float = 0.005) -> torch.Tensor:
    """SimpleWB: per-channel percentile stretch to [0, 1]
    (xphoto/src/simple_color_balance.cpp). The percentiles are
    `torch.quantile`'s, jnp.quantile's linear rule; it takes at most 2**24
    values a channel (a 1080p frame has 2.1 M)."""
    flat = img.reshape(-1, img.shape[-1]).to(torch.float32)
    if flat.shape[0] > 2 ** 24:
        raise ValueError(f"simple_wb: torch.quantile takes at most 2**24 values a channel, got {flat.shape[0]}")
    q = torch.tensor([p, 1.0 - p], dtype=torch.float32).to(flat.device)
    lo, hi = torch.quantile(flat, q, dim=0)
    return torch.clamp((img - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


def grayworld_wb(img: torch.Tensor, sat_thresh: float = 0.98) -> torch.Tensor:
    """GrayworldWB on (H, W, 3): scale the channels so their means over the
    pixels whose max channel is below `sat_thresh` agree
    (xphoto/src/grayworld_white_balance.cpp). The gated sums and their
    count are four grid_reduce launches, the gains three grid_transform
    launches, each on a channel read and written in place."""
    x = img.to(torch.float32)
    if x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"grayworld_wb: takes (H, W, 3), got {tuple(x.shape)}")
    rgb = (x[..., 0], x[..., 1], x[..., 2])
    sums = torch.stack([reduce.grid_reduce(transform.gated(sat_thresh, c), *rgb) for c in range(3)])
    count = reduce.grid_reduce(transform.gated_count(sat_thresh), *rgb)
    means = sums / torch.clamp(count, min=1.0)
    gains = torch.mean(means) / torch.clamp(means, min=1e-6)
    out = torch.empty_like(x)
    for c in range(3):
        transform.grid_transform(transform.gain(gains, c), rgb[c], out=out[..., c])
    return out
