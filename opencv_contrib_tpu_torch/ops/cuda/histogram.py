"""Histograms of a 2D image, or of a grid of its tiles in one launch.

Kernel: `csrc/histogram.cu`. It replaces the Pallas `grid_histogram`
(opencv_contrib_tpu/ops/pallas/grid.py:205) in the role its docstring names,
cudev's gridHistogram: on the photometric path it counts CLAHE's 64 tile
histograms in one launch and the frame histogram of `ops/histogram.py`. It is
bound by bytes (each value read once); counts are int32 in shared memory,
then integer atomics, so they are exact and repeatable, and are returned as
float32.

Two bin rules (`RULES`), one kernel template parameter:

- "drop", the Pallas contract: NaN, v < vmin and v >= vmax are dropped;
  bin = clip((v - vmin) * (bins / (vmax - vmin)), 0, bins - 1);
- "clamp", the contract of `ops/histogram.py::histogram` and CLAHE:
  x = clip((v - vmin) / (vmax - vmin), 0, 1 - 1e-7), bin = x * bins, so
  values out of range land in the end bins and NaN in bin 0.

With vmin 0 and vmax 1, "clamp" gives every value the bin CLAHE's
clip((v * bins).astype(int32), 0, bins - 1) gives it. Plain version beside
the kernel: `grid_histogram_plain` (the same index arithmetic, counted with
`torch.bincount`).
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops.cuda import _build, use_kernel
from opencv_contrib_tpu_torch.ops.cuda.transform import f32

RULES = {"drop": 0, "clamp": 1}  # csrc/histogram.cu DROP, CLAMP
BELOW_ONE = f32(1.0 - 1e-7)
_THREADS = 256  # csrc/histogram.cu THREADS
_ITEMS = 16  # values a thread counts, at least, before another block is added
_MAX_BLOCKS = 8 * 132  # eight blocks per SM of an H100, over all tiles
_MAX_BINS = 12288  # int32 bins in 48 KB of shared memory


def _q(rule: str, bins: int, vmin: float, vmax: float) -> float:
    """The float32 scale (drop) or range (clamp), rounded from the Python
    double as a JAX weak-typed scalar is."""
    return f32(bins / (vmax - vmin) if rule == "drop" else vmax - vmin)


def bin_index(x: torch.Tensor, bins: int, vmin: float, vmax: float, rule: str) -> torch.Tensor:
    """The int64 bin of every value, -1 where the rule drops it."""
    q = _q(rule, bins, vmin, vmax)
    if rule == "drop":
        ok = (x >= f32(vmin)) & (x < f32(vmax))
        idx = torch.clamp((x - f32(vmin)) * q, 0.0, bins - 1).to(torch.int64)
        return torch.where(ok, idx, -1)
    v = (x - f32(vmin)) / q
    v = torch.where(torch.isnan(v), 0.0, torch.clamp(v, 0.0, BELOW_ONE))
    return (v * float(bins)).to(torch.int64)


def _tiles_of(x: torch.Tensor, tiles) -> torch.Tensor:
    """(ty * tx, th, tw) tiles of the top-left crop of x (H, W)."""
    ty, tx = tiles
    th, tw = x.shape[0] // ty, x.shape[1] // tx
    return x[:th * ty, :tw * tx].reshape(ty, th, tx, tw).transpose(1, 2).reshape(ty * tx, th, tw)


def grid_histogram_plain(x: torch.Tensor, bins: int, vmin: float, vmax: float, rule: str = "drop",
                         tiles=None) -> torch.Tensor:
    """Counts of x (H, W) in `bins` bins over [vmin, vmax) by `rule`, as
    float32 (bins,); with tiles = (ty, tx), one histogram for each tile of
    the crop x[:H // ty * ty, :W // tx * tx] in row-major tile order,
    (ty * tx, bins)."""
    if tiles is None:
        idx = bin_index(x, bins, vmin, vmax, rule).reshape(-1)
        return torch.bincount(idx[idx >= 0], minlength=bins).to(torch.float32)
    t = _tiles_of(x, tiles)
    idx = bin_index(t, bins, vmin, vmax, rule).reshape(t.shape[0], -1)
    flat = idx + bins * torch.arange(t.shape[0], device=x.device)[:, None]
    counts = torch.bincount(flat[idx >= 0], minlength=t.shape[0] * bins)
    return counts.reshape(t.shape[0], bins).to(torch.float32)


def grid_histogram(x: torch.Tensor, bins: int, vmin: float, vmax: float, rule: str = "drop",
                   tiles=None) -> torch.Tensor:
    """Histogram(s) of x (H, W), float32, as `grid_histogram_plain`. A CUDA
    tensor launches the grid_histogram kernel (one launch for all tiles); a
    CPU tensor takes the plain version."""
    if rule not in RULES:
        raise ValueError(f"grid_histogram: rule must be one of {sorted(RULES)}, got {rule!r}")
    if not vmax > vmin or bins < 1:
        raise ValueError(f"grid_histogram: needs vmax > vmin and bins >= 1, got [{vmin}, {vmax}), {bins}")
    if not use_kernel(x):
        return grid_histogram_plain(x, bins, vmin, vmax, rule, tiles)
    if x.ndim != 2 or x.dtype != torch.float32 or x.stride(1) != 1:
        raise ValueError(f"grid_histogram: the kernel takes float32 (H, W) with unit column stride, got "
                         f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
    if bins > _MAX_BINS:
        raise ValueError(f"grid_histogram: at most {_MAX_BINS} bins in shared memory, got {bins}")
    H, W = x.shape
    ty, tx = (1, 1) if tiles is None else tiles
    rows, cols = H // ty, W // tx
    if rows * cols == 0:
        raise ValueError(f"grid_histogram: {H}x{W} has no {ty}x{tx} tiles")
    if H * W >= 2 ** 31:
        raise ValueError(f"grid_histogram: {H}x{W} has 2**31 elements or more")
    n_tiles = ty * tx
    per_tile = max(1, min(-(-rows * cols // (_THREADS * _ITEMS)), _MAX_BLOCKS // n_tiles))
    counts = torch.zeros((n_tiles, bins), dtype=torch.int32, device=x.device)
    lib = _build.lib("histogram")
    with _build.on_device(x.device):
        _build.check(lib.grid_histogram_f32(x.data_ptr(), RULES[rule], x.stride(0), rows, cols, ty, tx, bins,
                                            f32(vmin), f32(vmax),
                                            _q(rule, bins, vmin, vmax), per_tile, counts.data_ptr(),
                                            _build.stream_of(x)), "grid_histogram_f32")
    grid_histogram.launches += 1
    out = counts.to(torch.float32)
    return out[0] if tiles is None else out


grid_histogram.launches = 0
