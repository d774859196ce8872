"""Elementwise maps: `grid_transform` over N same-shape 2D views, and
`streamed_transform` over one whole array; and the maps both they and
`reduce.grid_reduce` take.

Kernels: `csrc/transform.cu` (the maps in `csrc/maps.cuh`). They replace the
Pallas `grid_transform` (opencv_contrib_tpu/ops/pallas/grid.py:54) and
`streamed_transform` (opencv_contrib_tpu/ops/pallas/pipeline.py:143) in the
roles their docstrings name: cudev's gridTransform, and the Stream/Async
overlap of a map over an array that lives in device memory. On the
photometric / quality path they apply the grayworld gains, convert RGB to
gray and compute the SSIM, GMS and MSCN maps and BRISQUE's pairwise
products, and the clip-wide gamma. Both are bound by bytes. grid_transform
walks rows (a block a band of rows, a thread columns) with float4 accesses
where every view is contiguous along its rows and 16-byte aligned
(`vec4_path`), and scalar ones otherwise (channel views).

A CUDA kernel cannot take a Python `op`, so a map is a `Map`: its number in
`csrc/maps.cuh` (MAP_CODES), its arity, its host parameters (floats) and
device parameters (a float32 tensor, read by the kernel without a host
sync), and its plain PyTorch expression `fn`, written with the operations of
the kernel's functor in the same order, so the two give the same bits (the
gamma map's `powf` within 2 ulp). The factories below build the maps this
path uses and no others.

Plain versions beside the kernels: `grid_transform_plain` and
`streamed_transform_plain` keep the Pallas functions' contracts for any
callable `op` (tiles or row blocks, zero padding, crop).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops.cuda import _build, use_kernel

# csrc/maps.cuh MAP_*
MAP_CODES = {"gamma": 0, "gray": 1, "gain": 2, "ssim": 3, "gms": 4, "mscn": 5, "mul": 6, "ident": 7,
             "sqdiff": 8, "sq": 9, "abs": 10, "neg_sq": 11, "pos_sq": 12, "neg": 13, "pos": 14, "gated": 15,
             "gated_count": 16, "sqdev": 17}
TRANSFORM_MAPS = ("gamma", "gray", "gain", "ssim", "gms", "mscn", "mul")
# csrc/maps.cuh GROUP_*: grid_reduce_sums' multi-output groups (their maps:
# the constructors in GROUPS below)
GROUP_CODES = {"ggd": 0, "aggd": 1, "grayworld": 2}
_CHUNK = 2048  # csrc/transform.cu CHUNK: floats a streamed block stages at once
_STREAM_BLOCKS = 8 * 132  # streamed_transform: eight persistent blocks (16 KB of staging each) per SM


class Map(NamedTuple):
    name: str  # a key of MAP_CODES
    n_in: int
    fn: Callable  # the plain PyTorch map of n_in same-shape tensors
    hparams: tuple = ()  # host floats, at most 4
    dparams: torch.Tensor | None = None  # device parameters (float32)


class Group(NamedTuple):
    """K sum maps over the same inputs that `reduce.grid_reduce_sums` folds
    in one pass: one of csrc/maps.cuh's GROUP_* functors, as the
    constructors below build them."""
    name: str  # a key of GROUP_CODES and GROUPS
    maps: tuple  # the Maps, in output order
    hparams: tuple = ()  # the constructor's arguments, the functor's host floats


def f32(v: float) -> float:
    """v rounded to float32, as a tensor operation rounds a Python scalar."""
    return float(np.float32(v))


# ---- the transform maps -----------------------------------------------------

def gamma(g: float) -> Map:
    g = f32(g)
    return Map("gamma", 1, lambda x: torch.clamp(x, 0.0, 1.0) ** g, (g,))


def gray() -> Map:
    """ITU-R BT.601 luma of (r, g, b), OpenCV's weights."""
    return Map("gray", 3, lambda r, g, b: r * 0.299 + g * 0.587 + b * 0.114)


def gain(gains: torch.Tensor, ch: int) -> Map:
    """clip(x * gains[ch], 0, 1) for channel ch; gains (3,) on the device."""
    return Map("gain", 1, lambda x: torch.clamp(x * gains[ch], 0.0, 1.0), (float(ch),), gains)


def ssim(c1: float, c2: float) -> Map:
    """The SSIM map of (mu_a, mu_b, blur(a a), blur(b b), blur(a b))."""
    c1, c2 = f32(c1), f32(c2)

    def fn(mu_a, mu_b, saa, sbb, sab):
        va = saa - mu_a * mu_a
        vb = sbb - mu_b * mu_b
        cov = sab - mu_a * mu_b
        return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a * mu_a + mu_b * mu_b + c1) * (va + vb + c2))

    return Map("ssim", 5, fn, (c1, c2))


def gms(c: float) -> Map:
    """Gradient-magnitude similarity of (gax, gay, gbx, gby)."""
    c = f32(c)

    def fn(gax, gay, gbx, gby):
        ma = torch.sqrt(gax * gax + gay * gay)
        mb = torch.sqrt(gbx * gbx + gby * gby)
        return (2 * ma * mb + c) / (ma * ma + mb * mb + c)

    return Map("gms", 4, fn, (c,))


def mscn() -> Map:
    """(x - mu) / (sqrt(max(blur(x x) - mu mu, 0)) + 1) of (x, mu, blur(x x))."""
    return Map("mscn", 3, lambda x, mu, s2: (x - mu) / (torch.sqrt(torch.clamp(s2 - mu * mu, min=0.0)) + 1.0))


def mul() -> Map:
    return Map("mul", 2, lambda a, b: a * b)


# ---- the reduce maps (reduce.grid_reduce) ---------------------------------------

def ident() -> Map:
    return Map("ident", 1, lambda x: x)


def sqdiff() -> Map:
    return Map("sqdiff", 2, lambda a, b: (a - b) * (a - b))


def sq() -> Map:
    return Map("sq", 1, lambda x: x * x)


def abs_() -> Map:
    return Map("abs", 1, torch.abs)


def neg_sq() -> Map:
    return Map("neg_sq", 1, lambda x: torch.where(x < 0, x * x, 0.0))


def pos_sq() -> Map:
    return Map("pos_sq", 1, lambda x: torch.where(x > 0, x * x, 0.0))


def neg() -> Map:
    return Map("neg", 1, lambda x: (x < 0).to(torch.float32))


def pos() -> Map:
    return Map("pos", 1, lambda x: (x > 0).to(torch.float32))


def _gate(r, g, b, sat):
    return (torch.maximum(torch.maximum(r, g), b) < sat).to(torch.float32)


def gated(sat: float, ch: int) -> Map:
    """Channel ch of (r, g, b) times 1 where max(r, g, b) < sat, else 0."""
    sat = f32(sat)
    return Map("gated", 3, lambda r, g, b: (r, g, b)[ch] * _gate(r, g, b, sat), (sat, float(ch)))


def gated_count(sat: float) -> Map:
    sat = f32(sat)
    return Map("gated_count", 3, lambda r, g, b: _gate(r, g, b, sat), (sat,))


def sqdev(mean: torch.Tensor) -> Map:
    """(x - mean) ** 2 for a one-element mean on the device."""
    m = mean.reshape(1)
    return Map("sqdev", 1, lambda x: (x - m[0]) * (x - m[0]), (), m)


# ---- the groups of grid_reduce_sums (csrc/maps.cuh GROUP_*) ----------------------

def ggd_moments() -> Group:
    """BRISQUE's GGD fit: the sums of x * x and |x|."""
    return Group("ggd", (sq(), abs_()))


def aggd_moments() -> Group:
    """BRISQUE's AGGD fit: the counts and square sums of each side, and the
    sums of |x| and x * x."""
    return Group("aggd", (neg(), pos(), neg_sq(), pos_sq(), abs_(), sq()))


def grayworld_sums(sat: float) -> Group:
    """Grayworld: the gated sums of channels 0, 1, 2 and their count."""
    sat = f32(sat)
    return Group("grayworld", (gated(sat, 0), gated(sat, 1), gated(sat, 2), gated_count(sat)), (sat,))


GROUPS = {"ggd": ggd_moments, "aggd": aggd_moments, "grayworld": grayworld_sums}


# ---- plain versions ------------------------------------------------------------

def _pad2(x: torch.Tensor, th: int, tw: int, fill: float = 0.0) -> torch.Tensor:
    H, W = x.shape
    ph, pw = (-H) % th, (-W) % tw
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=fill)
    return x


def grid_transform_plain(op: Callable, *arrays: torch.Tensor, tile=(256, 256)) -> torch.Tensor:
    """out[i, j] = op(a0[i, j], a1[i, j], ...), tile by tile over the arrays
    zero-padded to a multiple of the tile, cropped to (H, W): the Pallas
    `grid_transform`."""
    H, W = arrays[0].shape
    th, tw = min(tile[0], H), min(tile[1], W)
    padded = [_pad2(a, th, tw) for a in arrays]
    rows = []
    for i in range(0, padded[0].shape[0], th):
        rows.append(torch.cat([op(*(a[i:i + th, j:j + tw] for a in padded))
                               for j in range(0, padded[0].shape[1], tw)], dim=1))
    return torch.cat(rows, dim=0)[:H, :W]


def streamed_transform_plain(op: Callable, x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """op over (H, W), block rows at a time, on x zero-padded to a multiple
    of the block: the Pallas `streamed_transform`."""
    H, W = x.shape
    bh = min(block, H)
    xp = F.pad(x, (0, 0, 0, (-H) % bh))
    return torch.cat([op(xp[i:i + bh]) for i in range(0, xp.shape[0], bh)], dim=0)[:H]


# ---- the kernels ---------------------------------------------------------------

def check_map(m: Map, arrays, who: str) -> None:
    if m.name not in MAP_CODES:
        raise ValueError(f"{who}: unknown map {m.name!r}")
    if len(arrays) != m.n_in:
        raise ValueError(f"{who}: map {m.name} takes {m.n_in} arrays, got {len(arrays)}")
    if len(m.hparams) > 4:
        raise ValueError(f"{who}: at most 4 host parameters")


def check_views(arrays, who: str, device) -> tuple:
    """The (H, W) of 2D float32 views on one CUDA device; raises otherwise."""
    shape = tuple(arrays[0].shape)
    for a in arrays:
        if a.device != device or a.dtype != torch.float32 or a.ndim != 2 or tuple(a.shape) != shape:
            raise ValueError(f"{who}: the kernel takes float32 (H, W) views of one shape on {device}, "
                             f"got {tuple(a.shape)} {a.dtype} on {a.device}")
    if shape[0] * shape[1] == 0 or shape[0] * shape[1] >= 2 ** 31:
        raise ValueError(f"{who}: {shape} is empty or has 2**31 elements or more")
    if any((shape[1] - 1) * a.stride(1) >= 2 ** 31 for a in arrays):
        raise ValueError(f"{who}: a row spans 2**31 elements or more (the kernel's column offsets are 32-bit)")
    return shape


def vec4_path(arrays) -> bool:
    """True when every view takes the kernels' float4 path (csrc/maps.cuh,
    the row walk): stride 1, a row pitch that is a multiple of 4 (or one
    row), a 16-byte aligned pointer; else they take the strided path."""
    return all(a.stride(1) == 1 and (a.stride(0) % 4 == 0 or a.shape[0] == 1) and a.data_ptr() % 16 == 0
               for a in arrays)


def pack_views(arrays) -> ctypes.Array:
    """(pointer, row pitch, element stride) of each view, as csrc/maps.cuh
    `unpack` reads them."""
    vals = []
    for a in arrays:
        vals += [a.data_ptr(), a.stride(0), a.stride(1)]
    return (ctypes.c_longlong * len(vals))(*vals)


def pack_params(m: Map, device, who: str):
    hp = (ctypes.c_float * 4)(*m.hparams, *([0.0] * (4 - len(m.hparams))))
    dp = m.dparams
    if dp is not None:
        if dp.device != device or dp.dtype != torch.float32 or not dp.is_contiguous():
            raise ValueError(f"{who}: device parameters must be a contiguous float32 tensor on {device}")
        return hp, dp.data_ptr()
    return hp, None


def grid_transform(m: Map, *arrays: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """m over the (H, W) views `arrays` (any strides): a new (H, W) float32,
    or written into the (H, W) view `out`. A CUDA tensor launches the
    grid_transform kernel; a CPU tensor takes `grid_transform_plain(m.fn)`."""
    check_map(m, arrays, "grid_transform")
    if m.name not in TRANSFORM_MAPS:
        raise ValueError(f"grid_transform: {m.name} is a reduce map")
    if not use_kernel(arrays[0]):
        res = grid_transform_plain(m.fn, *arrays)
        if out is None:
            return res
        out.copy_(res)
        return out
    dev = arrays[0].device
    H, W = check_views(arrays, "grid_transform", dev)
    if out is None:
        out = torch.empty((H, W), dtype=torch.float32, device=dev)
    check_views([out], "grid_transform (out)", dev)
    if tuple(out.shape) != (H, W):
        raise ValueError(f"grid_transform: out is {tuple(out.shape)}, expected {(H, W)}")
    views = pack_views([*arrays, out])
    hp, dp = pack_params(m, dev, "grid_transform")
    lib = _build.lib("transform")
    with _build.on_device(dev):
        _build.check(lib.grid_transform_f32(MAP_CODES[m.name], m.n_in, ctypes.addressof(views), ctypes.addressof(hp),
                                            dp, H, W, int(vec4_path([*arrays, out])), _build.stream_of(out)),
                     "grid_transform_f32")
    grid_transform.launches += 1
    return out


grid_transform.launches = 0


def streamed_transform(m: Map, x: torch.Tensor) -> torch.Tensor:
    """The one-input map m over the whole of x (H, W). A CUDA tensor
    launches the streamed_transform kernel (one launch, however large x is);
    a CPU tensor takes `streamed_transform_plain(m.fn)`."""
    check_map(m, (x,), "streamed_transform")
    if m.name not in TRANSFORM_MAPS:
        raise ValueError(f"streamed_transform: {m.name} is a reduce map")
    if x.ndim != 2:
        raise ValueError(f"streamed_transform: takes (H, W), got {tuple(x.shape)}")
    if not use_kernel(x):
        return streamed_transform_plain(m.fn, x)
    if x.dtype != torch.float32:
        raise ValueError(f"streamed_transform: the kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    n = x.numel()
    if n == 0 or n >= 2 ** 31:
        raise ValueError(f"streamed_transform: {n} elements; the kernel takes 1 to 2**31 - 1")
    if x.data_ptr() % 16:
        raise ValueError("streamed_transform: the kernel stages 16-byte copies; x must be 16-byte aligned")
    out = torch.empty_like(x)
    hp, dp = pack_params(m, x.device, "streamed_transform")
    blocks = max(1, min(-(-n // _CHUNK), _STREAM_BLOCKS))
    lib = _build.lib("transform")
    with _build.on_device(x.device):
        _build.check(lib.streamed_transform_f32(MAP_CODES[m.name], ctypes.addressof(hp), dp, x.data_ptr(),
                                                out.data_ptr(), n, blocks, _build.stream_of(x)),
                     "streamed_transform_f32")
    streamed_transform.launches += 1
    return out


streamed_transform.launches = 0


def as_2d(x: torch.Tensor) -> torch.Tensor:
    """x as the (rows, columns) array the kernels take: (H, W) as it is,
    (..., H, W, C) as (-1, W * C), a vector as one row."""
    if x.ndim == 2:
        return x
    if x.ndim == 1:
        return x.reshape(1, -1)
    return x.reshape(-1, x.shape[-2] * x.shape[-1])
