"""Histograms, equalization and CLAHE (the port of
opencv_contrib_tpu/ops/histogram.py, cudaimgproc's histogram family).

The JAX version counts with one-hot matrix products and looks LUTs up with
one-hot products, because TPU scatters and gathers pay per row
(histogram.py:13-56). Here counts come from the grid_histogram kernel
(`ops/cuda/histogram.py`, the "clamp" rule of `histogram`), CLAHE's 64 tile
histograms from one batched launch of it, and LUT lookups are direct
gathers.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops.cuda import histogram as khist


def histogram(img: torch.Tensor, bins: int = 256, vmin: float = 0.0, vmax: float = 1.0) -> torch.Tensor:
    """Histogram of values in [vmin, vmax] over `bins` buckets, float32:
    out-of-range values count in the end bins, NaN in bin 0."""
    x = img.to(torch.float32)
    x = x.reshape(1, -1) if x.ndim != 2 else x
    return khist.grid_histogram(x, bins, vmin, vmax, rule="clamp")


def lut_lookup(idx: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """lut[idx] as float32, a direct gather."""
    return lut.to(torch.float32)[idx.long()]


def _bin_of(img: torch.Tensor, bins: int) -> torch.Tensor:
    """clip((img * bins).astype(int32), 0, bins - 1) with XLA's conversion
    of NaN (to 0) and of values past the int32 range (saturated)."""
    v = torch.nan_to_num(img * bins, nan=0.0)
    return torch.clamp(v, 0.0, bins - 1).to(torch.int64)


def equalize_hist(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Histogram equalization of a float image in [0, 1]."""
    h = histogram(img, bins)
    cdf = torch.cumsum(h, 0)
    cdf = cdf / torch.clamp(cdf[-1], min=1.0)
    return lut_lookup(_bin_of(img, bins), cdf)


def clahe(img: torch.Tensor, clip_limit: float = 4.0, grid: int = 8, bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of (H, W) in [0, 1]
    (cv::cuda::CLAHE): the grid x grid tile histograms of the crop
    img[:H // grid * grid, :W // grid * grid] in one grid_histogram launch,
    clipped and redistributed, per-tile LUTs from their cumulative sums,
    and over the whole image a bilinear blend of the four nearest tiles'
    LUT values. The JAX version blends by a one-hot product and a 64-term
    weighted sum; the four corner values are gathered here, so the sums
    round in another order (about 1e-7)."""
    x = img.to(torch.float32)
    H, W = x.shape
    th, tw = H // grid, W // grid
    # (v * bins) truncated and clipped is the "clamp" rule's bin on [0, 1)
    counts = khist.grid_histogram(x, bins, 0.0, 1.0, rule="clamp", tiles=(grid, grid))  # (g*g, bins)
    limit = clip_limit * (th * tw) / bins
    excess = torch.sum(torch.clamp(counts - limit, min=0.0), dim=1, keepdim=True)
    clipped = torch.clamp(counts, max=limit) + excess / bins
    cdf = torch.cumsum(clipped, dim=1)
    luts = (cdf / torch.clamp(cdf[:, -1:], min=1.0)).reshape(-1)  # (g*g*bins,)

    dev = x.device
    y = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ty = torch.clamp((y - th / 2) / th, 0.0, grid - 1.0)
    tx = torch.clamp((xs - tw / 2) / tw, 0.0, grid - 1.0)
    ty0, tx0 = torch.floor(ty), torch.floor(tx)
    wy, wx = (ty - ty0)[:, None], (tx - tx0)[None, :]
    ty0, tx0 = ty0.long(), tx0.long()
    ty1 = torch.clamp(ty0 + 1, max=grid - 1)
    tx1 = torch.clamp(tx0 + 1, max=grid - 1)
    bi = _bin_of(x, bins)

    def corner(tyi, txi):
        return luts[(tyi[:, None] * grid + txi[None, :]) * bins + bi]

    return ((1 - wy) * (1 - wx) * corner(ty0, tx0) + (1 - wy) * wx * corner(ty0, tx1)
            + wy * (1 - wx) * corner(ty1, tx0) + wy * wx * corner(ty1, tx1))
