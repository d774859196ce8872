"""White balance (the port of opencv_contrib_tpu/xphoto/white_balance.py:
xphoto SimpleWB and GrayworldWB)."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops.cuda import reduce, transform


def _quantile_linear(flat: torch.Tensor, qs) -> list:
    """The q-quantiles (q in `qs`) of each column of (n, C) by numpy's (and
    jnp's) "linear" rule, for any n: one sort along the rows; for each q the
    virtual index q (n - 1) in float32, as np.quantile takes it for float32
    data, the floor and next elements, and numpy's interpolation between
    them (from the nearer end). A column that holds NaN gives NaN. Every
    index and weight is a host scalar, so nothing is copied to the device."""
    n = flat.shape[0]
    s = torch.sort(flat, dim=0).values
    nan = torch.isnan(s[-1])
    out = []
    for q in qs:
        pos = np.float32(n - 1) * np.float32(q)
        lo = min(int(np.floor(pos)), n - 1)
        hi = min(lo + 1, n - 1)
        t = np.float32(pos - np.float32(lo)) if lo < n - 1 else np.float32(0.0)
        a, b = s[lo], s[hi]
        d = b - a
        r = b - d * float(np.float32(1.0) - t) if t >= 0.5 else a + d * float(t)
        out.append(torch.where(nan, s[-1], r))
    return out


def simple_wb(img: torch.Tensor, p: float = 0.005) -> torch.Tensor:
    """SimpleWB: per-channel percentile stretch to [0, 1]
    (xphoto/src/simple_color_balance.cpp). The percentiles follow the
    linear rule of jnp.quantile (`_quantile_linear`), for any number of
    values a channel."""
    flat = img.reshape(-1, img.shape[-1]).to(torch.float32)
    lo, hi = _quantile_linear(flat, (p, 1.0 - p))
    return torch.clamp((img - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


def grayworld_wb(img: torch.Tensor, sat_thresh: float = 0.98) -> torch.Tensor:
    """GrayworldWB on (H, W, 3): scale the channels so their means over the
    pixels whose max channel is below `sat_thresh` agree
    (xphoto/src/grayworld_white_balance.cpp). The gated sums and their
    count are one grid_reduce_sums launch, the gains three grid_transform
    launches, each on a channel read and written in place."""
    x = img.to(torch.float32)
    if x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"grayworld_wb: takes (H, W, 3), got {tuple(x.shape)}")
    rgb = (x[..., 0], x[..., 1], x[..., 2])
    sums = reduce.grid_reduce_sums(transform.grayworld_sums(sat_thresh), *rgb)
    means = sums[:3] / torch.clamp(sums[3], min=1.0)
    gains = torch.mean(means) / torch.clamp(means, min=1e-6)
    out = torch.empty_like(x)
    for c in range(3):
        transform.grid_transform(transform.gain(gains, c), rgb[c], out=out[..., c])
    return out
