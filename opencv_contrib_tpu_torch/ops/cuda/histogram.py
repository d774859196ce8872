"""Histograms of a 2D image, or of a grid of its tiles in one launch.

Kernel: `csrc/histogram.cu`. It replaces the Pallas `grid_histogram`
(opencv_contrib_tpu/ops/pallas/grid.py:205) in the role its docstring names,
cudev's gridHistogram: on the photometric path it counts CLAHE's 64 tile
histograms in one launch and the frame histogram of `ops/histogram.py`. It is
bound by bytes (each value read once). One launch a call, with no memset and
no cast: `plan` gives each tile blocks that take equal runs of its values
(float4 loads where `vec4_walk` holds, scalar ones otherwise), which count
into int32 bins in shared memory; a tile's blocks add their counts into
cached scratch (`_scratch_for`) and the block that draws the tile's last
ticket writes them as float32 and zeroes the scratch again. Integer sums,
so the counts are exact and repeatable.

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

import math

import torch

from opencv_contrib_tpu_torch.ops.cuda import _build, use_kernel
from opencv_contrib_tpu_torch.ops.cuda.transform import f32

RULES = {"drop": 0, "clamp": 1}  # csrc/histogram.cu DROP, CLAMP
BELOW_ONE = f32(1.0 - 1e-7)
_THREADS = 256  # csrc/histogram.cu THREADS
_ITEMS = 16  # values a thread counts, at least, before a tile takes another block
_MAX_BLOCKS = 4 * 132  # four blocks per SM of an H100, over all tiles
_SMEM = 48 * 1024  # csrc/histogram.cu SMEM: the shared bins
_MAX_BINS = _SMEM // 4  # int32 bins in _SMEM
_SPREAD_BLOCKS = 32  # blocks of a tile, at most, that add into one copy of its counts
_MAX_SPREAD = 16  # csrc/histogram.cu MAX_SPREAD: copies of a tile's counts
_MAX_TILES = 65535  # the grid's y dimension


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
    # a divisor on x's device: PyTorch's CUDA division by a Python scalar
    # multiplies by the scalar's reciprocal, which rounds otherwise than the
    # quotient the rule (and the CPU, and the kernel) takes
    v = (x - f32(vmin)) / torch.full((), q, dtype=torch.float32, device=x.device)
    v = torch.where(torch.isnan(v), 0.0, torch.clamp(v, 0.0, BELOW_ONE))
    return (v * float(bins)).to(torch.int64)


def vec4_walk(x: torch.Tensor, rows: int, cols: int, tiles_y: int) -> bool:
    """True when every tile of x starts on 16 bytes and its rows do too, so
    the kernel reads float4s: a 16-byte aligned pointer, tiles a multiple of
    4 wide, and a row pitch that is a multiple of 4 (or a single row)."""
    return x.data_ptr() % 16 == 0 and cols % 4 == 0 and (x.stride(0) % 4 == 0 or rows * tiles_y == 1)


def plan(rows: int, cols: int, n_tiles: int, vec4: bool) -> tuple[int, int, int]:
    """(blocks a tile, units a block, copies of a tile's counts) of the
    kernel for n_tiles tiles of rows x cols (units: float4s on the vec4
    walk, else floats): at least _ITEMS values a thread before a tile takes
    another block, at most _MAX_BLOCKS blocks over all tiles (and at least
    one a tile), no block empty; at most _SPREAD_BLOCKS blocks adding into
    one copy of the counts, up to _MAX_SPREAD copies. It depends on the
    shape and the walk alone."""
    units = rows * (cols // 4 if vec4 else cols)
    want = -(-rows * cols // (_THREADS * _ITEMS))
    per_tile = max(1, min(want, _MAX_BLOCKS // n_tiles))
    chunk = -(-units // per_tile)
    per_tile = -(-units // chunk)
    return per_tile, chunk, min(_MAX_SPREAD, -(-per_tile // _SPREAD_BLOCKS))


def _inverse(rule: str, q: float) -> float:
    """1 / q where the clamp rule's quotient by q equals the product by it
    (q a power of two, its inverse a normal float32), else 0. The kernel
    multiplies there, which is faster than its correctly rounded division."""
    m, e = math.frexp(q)
    return 2.0 ** (1 - e) if rule == "clamp" and m == 0.5 and -125 <= e <= 126 else 0.0


_scratch: dict = {}


def _scratch_for(dev: torch.device, stream: int, n_tiles: int, bins: int):
    """The tiles' tickets and int32 counts (`bins` a tile: the bins of all
    its copies), zero between launches (a tile's last block sets them back),
    made once per device and stream and grown when a call needs more;
    launches on one stream run one after another."""
    tickets, counts = _scratch.get((dev, stream), (None, None))
    if tickets is None or tickets.numel() < n_tiles:
        tickets = torch.zeros(max(n_tiles, 64), dtype=torch.int32, device=dev)
    if counts is None or counts.numel() < n_tiles * bins:
        counts = torch.zeros(max(n_tiles * bins, 64 * 256), dtype=torch.int32, device=dev)
    _scratch[(dev, stream)] = (tickets, counts)
    return tickets, counts


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


def _check_kernel_input(x: torch.Tensor, bins: int, tiles) -> tuple[int, int, int, int]:
    """(rows, cols, tiles_y, tiles_x) of the kernel's launch on x; raises on
    what the kernel does not take."""
    if x.ndim != 2 or x.dtype != torch.float32 or x.stride(1) != 1:
        raise ValueError(f"grid_histogram: the kernel takes float32 (H, W) with unit column stride, got "
                         f"{tuple(x.shape)} {x.dtype} strides {tuple(x.stride())}")
    if bins > _MAX_BINS:
        raise ValueError(f"grid_histogram: at most {_MAX_BINS} bins in shared memory, got {bins}")
    H, W = x.shape
    ty, tx = (1, 1) if tiles is None else tiles
    rows, cols = H // ty, W // tx
    if rows * cols == 0:
        raise ValueError(f"grid_histogram: {H}x{W} has no {ty}x{tx} tiles")
    if (H - 1) * x.stride(0) + W >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"grid_histogram: {H}x{W} (row pitch {x.stride(0)}) spans 2**31 elements or more")
    if ty * tx > _MAX_TILES:
        raise ValueError(f"grid_histogram: at most {_MAX_TILES} tiles, got {ty}x{tx}")
    return rows, cols, ty, tx


def grid_histogram(x: torch.Tensor, bins: int, vmin: float, vmax: float, rule: str = "drop",
                   tiles=None) -> torch.Tensor:
    """Histogram(s) of x (H, W), float32, as `grid_histogram_plain`. A CUDA
    tensor launches the grid_histogram kernel once, for all tiles; a CPU
    tensor takes the plain version."""
    if rule not in RULES:
        raise ValueError(f"grid_histogram: rule must be one of {sorted(RULES)}, got {rule!r}")
    if not vmax > vmin or bins < 1:
        raise ValueError(f"grid_histogram: needs vmax > vmin and bins >= 1, got [{vmin}, {vmax}), {bins}")
    if not use_kernel(x):
        return grid_histogram_plain(x, bins, vmin, vmax, rule, tiles)
    rows, cols, ty, tx = _check_kernel_input(x, bins, tiles)
    n_tiles = ty * tx
    vec4 = vec4_walk(x, rows, cols, ty)
    per_tile, chunk, spread = plan(rows, cols, n_tiles, vec4)
    out = torch.empty((n_tiles, bins), dtype=torch.float32, device=x.device)
    stream = _build.stream_of(x)
    tickets, counts = _scratch_for(x.device, stream, n_tiles, spread * bins)
    q = _q(rule, bins, vmin, vmax)
    lib = _build.lib("histogram")
    with _build.on_device(x.device):
        _build.check(lib.grid_histogram_f32(x.data_ptr(), RULES[rule], int(vec4), x.stride(0), rows, cols, ty, tx,
                                            bins, f32(vmin), f32(vmax), q, _inverse(rule, q),
                                            per_tile, chunk, spread, tickets.data_ptr(), counts.data_ptr(),
                                            out.data_ptr(), stream), "grid_histogram_f32")
    grid_histogram.launches += 1
    return out[0] if tiles is None else out


grid_histogram.launches = 0
