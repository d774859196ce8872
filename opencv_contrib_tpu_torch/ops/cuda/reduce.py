"""Tiled map reductions: to a scalar (`grid_reduce`), to K sums in one pass
(`grid_reduce_sums`), and to a vector, with the ICP getAb system built by
one.

Kernel `csrc/reduce.cu` replaces the Pallas `grid_reduce`
(opencv_contrib_tpu/ops/pallas/grid.py:91), cudev's gridCalcSum / MinVal /
MaxVal: a fused map + sum, min or max. The map is one of the `Map`s of
`ops/cuda/transform.py` (functors in `csrc/maps.cuh`). On the photometric /
quality path it takes the MSE, the SSIM and GMSD means, and through
`grid_reduce_sums` grayworld's gated sums and BRISQUE's moments (one pass
per group of maps over the same inputs). One launch a call: the block that
finishes last folds the block partials in a fixed order (an integer ticket,
no float atomics), so a sum does not change from run to run, and each sum of
a group has the bits of its single-map call. Plain versions beside it:
`grid_reduce_plain` (the Pallas function's tiles, fill and neutral masking,
for any callable `map_op`) and `grid_reduce_sums_plain`.

Kernel `csrc/reduce_vec.cu` replaces the Pallas `grid_reduce_vec`
(opencv_contrib_tpu/ops/pallas/grid.py:155) in the role that function's
docstring names: assembling the point-to-plane ICP normal system of
`rgbd/icp.py::build_system` (fast_icp.cpp GetAbInvoker). A CUDA kernel
cannot take a Python `map_op`, so the kernel is a device-side template,
`grid_reduce_vec_kernel<Map>`, and `icp_getab` launches its one
instantiation, whose map is build_system's per-pixel body. It is bound by
bytes (at most 50 B per pixel, fewer where a gate rejects the pixel early).
One launch a call: `getab_plan` sizes the grid from the frame (sqrt(H W) / 2
blocks, at most two an SM), and the block partials are
folded by the block that draws the last ticket, in block order, in the same
cached scratch as grid_reduce's, so the result does not change from run to
run.

Plain versions beside it: `grid_reduce_vec_plain` (the Pallas function's
tile, pad and validity semantics, for any `map_op`) and `icp_getab_plain`
(the JAX build_system's einsum form).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops.cuda import _build, use_kernel
from opencv_contrib_tpu_torch.ops.cuda import transform as tf

_GETAB_THREADS = 256  # csrc/reduce_vec.cu THREADS
_GETAB_MAX_BLOCKS = 2 * 132  # csrc/reduce_vec.cu MAX_BLOCKS: two blocks per SM of an H100
_SUM_BLOCKS = 1024  # csrc/reduce.cu MAX_BLOCKS
_MAX_SUMS = 8  # grid_reduce_sums: outputs a launch
# the scratch of csrc/reduce.cu and csrc/reduce_vec.cu: the ticket (an
# unsigned int, 0 between launches), then _MAX_SUMS partials per block of
# grid_reduce, or _OUT per block of getAb, from float 4 on
_SCRATCH_FLOATS = 4 + _SUM_BLOCKS * _MAX_SUMS
_OUT = 29  # the getAb map's outputs
_RESULT = 44  # A (36), b (6), n_corr, mean_err
KINDS = {"sum": 0, "min": 1, "max": 2}  # csrc/reduce.cu SUM, MIN, MAX
_NEUTRAL = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
_RED = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}
_FOLD = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def grid_reduce_plain(map_op, *arrays: torch.Tensor, kind: str = "sum", tile=(256, 256)) -> torch.Tensor:
    """reduce(map_op(a0, a1, ...)) to a float32 scalar: the first array is
    padded to a multiple of the tile with the neutral element, the others
    with 0; each tile's padded cells are masked to the neutral element
    before its reduction, and the tiles are folded in grid order into one
    accumulator, as the Pallas `grid_reduce` does (with its default fill)."""
    H, W = arrays[0].shape
    th, tw = min(tile[0], H), min(tile[1], W)
    neutral = _NEUTRAL[kind]
    padded = [tf._pad2(a, th, tw, neutral if k == 0 else 0.0) for k, a in enumerate(arrays)]
    Hp, Wp = padded[0].shape
    dev = arrays[0].device
    rows = torch.arange(Hp, device=dev)[:, None]
    cols = torch.arange(Wp, device=dev)[None, :]
    valid = (rows < H) & (cols < W)
    acc = torch.full((), neutral, dtype=torch.float32, device=dev)
    for i in range(0, Hp, th):
        for j in range(0, Wp, tw):
            mapped = map_op(*(a[i:i + th, j:j + tw] for a in padded))
            val = _RED[kind](torch.where(valid[i:i + th, j:j + tw], mapped, neutral))
            acc = _FOLD[kind](acc, val.to(torch.float32))
    return acc


_scratch: dict = {}


def _scratch_for(dev: torch.device, stream: int) -> torch.Tensor:
    """The ticket and partials of grid_reduce and getAb, made once per
    device and stream: each kernel sets the ticket back to 0 at its end, and
    launches on one stream run one after another, so no two reductions
    share it at once."""
    buf = _scratch.get((dev, stream))
    if buf is None:
        buf = _scratch[(dev, stream)] = torch.zeros(_SCRATCH_FLOATS, dtype=torch.float32, device=dev)
    return buf


def grid_reduce(m: tf.Map, *arrays: torch.Tensor, kind: str = "sum", div: float = 1.0) -> torch.Tensor:
    """reduce(m(a0, a1, ...)) over the (H, W) views `arrays` (any strides),
    as a float32 scalar on their device; a sum is divided by `div` (the
    element count for a mean). A CUDA tensor launches the grid_reduce kernel;
    a CPU tensor takes `grid_reduce_plain(m.fn)`."""
    if kind not in KINDS:
        raise ValueError(f"grid_reduce: kind must be one of {sorted(KINDS)}, got {kind!r}")
    tf.check_map(m, arrays, "grid_reduce")
    if m.name in tf.TRANSFORM_MAPS:
        raise ValueError(f"grid_reduce: {m.name} is a transform map")
    if kind != "sum" and div != 1.0:
        raise ValueError("grid_reduce: div divides a sum only")
    if not use_kernel(arrays[0]):
        out = grid_reduce_plain(m.fn, *arrays, kind=kind)
        return out / div if div != 1.0 else out
    dev = arrays[0].device
    H, W = tf.check_views(arrays, "grid_reduce", dev)
    views = tf.pack_views(arrays)
    hp, dp = tf.pack_params(m, dev, "grid_reduce")
    out = torch.empty(1, dtype=torch.float32, device=dev)
    stream = _build.stream_of(out)
    lib = _build.lib("reduce")
    with _build.on_device(dev):
        _build.check(lib.grid_reduce_f32(tf.MAP_CODES[m.name], KINDS[kind], m.n_in, ctypes.addressof(views),
                                         ctypes.addressof(hp), dp, H, W, tf.f32(div), int(tf.vec4_path(arrays)),
                                         _scratch_for(dev, stream).data_ptr(), out.data_ptr(), stream),
                     "grid_reduce_f32")
    grid_reduce.launches += 1
    return out[0]


grid_reduce.launches = 0


def _divs(div, k: int) -> list:
    divs = [div] * k if isinstance(div, (int, float)) else list(div)
    if len(divs) != k:
        raise ValueError(f"grid_reduce_sums: div takes one float or one per map ({k}), got {len(divs)}")
    return divs


def grid_reduce_sums_plain(group: tf.Group, *arrays: torch.Tensor, div=1.0) -> torch.Tensor:
    """(K,) float32: `grid_reduce_plain` of each of the group's map sums,
    divided by its div, stacked."""
    out = []
    for m, d in zip(group.maps, _divs(div, len(group.maps))):
        r = grid_reduce_plain(m.fn, *arrays)
        out.append(r / d if d != 1.0 else r)
    return torch.stack(out)


def _key(group: tf.Group) -> tuple:
    return group.name, group.hparams, tuple((m.name, m.n_in, m.hparams) for m in group.maps)


def _check_group(group, kind: str) -> None:
    """Raises unless `group` is a group the kernel instantiates (K <= 8 sum
    maps of one arity), as its constructor in transform.GROUPS builds it."""
    if kind != "sum":
        raise ValueError(f"grid_reduce_sums: sums only, got kind {kind!r}; min and max take grid_reduce")
    try:
        want = tf.GROUPS[group.name](*group.hparams)
    except (AttributeError, KeyError, TypeError):
        want = None
    if want is None or _key(group) != _key(want):
        raise ValueError(f"grid_reduce_sums: {group!r} is not one of the kernel's groups; "
                         f"transform.{', transform.'.join(f.__name__ for f in tf.GROUPS.values())} build them")


def grid_reduce_sums(group: tf.Group, *arrays: torch.Tensor, div=1.0, kind: str = "sum") -> torch.Tensor:
    """(K,) float32 on the arrays' device: the sum of each of the group's K
    maps over the same (H, W) views, divided by `div` (one float, or one per
    map), in one pass. `group` is one of transform.GROUPS' (csrc/maps.cuh
    GROUP_*), and `kind` "sum": min and max take `grid_reduce`. A CUDA tensor
    launches the grid_reduce kernel once, and each sum has the bits of its
    single `grid_reduce` call; a CPU tensor takes `grid_reduce_sums_plain`."""
    _check_group(group, kind)
    maps = group.maps
    for m in maps:
        tf.check_map(m, arrays, "grid_reduce_sums")
    divs = _divs(div, len(maps))
    if not use_kernel(arrays[0]):
        return grid_reduce_sums_plain(group, *arrays, div=divs)
    dev = arrays[0].device
    H, W = tf.check_views(arrays, "grid_reduce_sums", dev)
    views = tf.pack_views(arrays)
    hp = (ctypes.c_float * 4)(*group.hparams, *([0.0] * (4 - len(group.hparams))))
    dv = (ctypes.c_float * len(maps))(*(tf.f32(d) for d in divs))
    out = torch.empty(len(maps), dtype=torch.float32, device=dev)
    stream = _build.stream_of(out)
    lib = _build.lib("reduce")
    with _build.on_device(dev):
        _build.check(lib.grid_reduce_sums_f32(tf.GROUP_CODES[group.name], maps[0].n_in, ctypes.addressof(views),
                                              ctypes.addressof(hp), H, W, ctypes.addressof(dv),
                                              int(tf.vec4_path(arrays)), _scratch_for(dev, stream).data_ptr(),
                                              out.data_ptr(), stream),
                     "grid_reduce_sums_f32")
    grid_reduce.launches += 1  # one launch of the grid_reduce kernel
    return out


def grid_reduce_vec_plain(map_op, *arrays: torch.Tensor, out_dim: int, tile=(256, 256)) -> torch.Tensor:
    """Sum over tiles of `map_op(*tiles, valid) -> (out_dim,)`: the arrays
    (H, W) are zero-padded to a multiple of the tile, and `valid` is False on
    the padded cells (map_op must zero their contributions), as the Pallas
    `grid_reduce_vec` passes them. Tiles are folded in grid order."""
    H, W = arrays[0].shape
    th, tw = min(tile[0], H), min(tile[1], W)
    ph, pw = (-H) % th, (-W) % tw
    padded = [F.pad(a, (0, pw, 0, ph)) for a in arrays]
    rows = torch.arange(H + ph, device=arrays[0].device)[:, None]
    cols = torch.arange(W + pw, device=arrays[0].device)[None, :]
    valid = (rows < H) & (cols < W)
    out = torch.zeros(out_dim, dtype=torch.float32, device=arrays[0].device)
    for i in range(0, H + ph, th):
        for j in range(0, W + pw, tw):
            tiles = [a[i:i + th, j:j + tw] for a in padded]
            out = out + map_op(*tiles, valid[i:i + th, j:j + tw]).to(torch.float32).reshape(out_dim)
    return out


def _cos32(angle: float) -> float:
    """cos(angle) in float32, as `jnp.cos` of a Python float computes it."""
    return float(np.cos(np.float32(angle)))


def icp_getab_plain(T, src_points, src_normals, src_valid, dst_points, dst_normals, dst_valid, intr,
                    dist_thresh: float = 0.1, angle_thresh: float = 0.52):
    """The getAb step in the JAX package's einsum form: (A (6, 6), b (6,),
    n_corr, mean_err) for the pose T mapping source camera -> target camera."""
    R, t = T[:3, :3], T[:3, 3]
    p = torch.einsum("ij,hwj->hwi", R, src_points) + t  # source points in the target frame
    z = torch.clamp(p[..., 2], min=1e-9)
    u = torch.addcmul(intr[2], p[..., 0] / z, intr[0])  # x / z * fx + cx
    v = torch.addcmul(intr[3], p[..., 1] / z, intr[1])
    H, W = dst_valid.shape
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (p[..., 2] > 0) & src_valid
    flat = (torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)).reshape(-1).long()
    q = dst_points.reshape(-1, 3)[flat].reshape(p.shape)
    n = dst_normals.reshape(-1, 3)[flat].reshape(p.shape)
    qv = dst_valid.reshape(-1)[flat].reshape(inb.shape)

    diff = p - q
    dist_ok = torch.sum(diff * diff, dim=-1) < dist_thresh * dist_thresh
    ns = torch.einsum("ij,hwj->hwi", R, src_normals)
    ang_ok = torch.sum(ns * n, dim=-1) > _cos32(angle_thresh)
    w = (inb & qv & dist_ok & ang_ok).to(torch.float32)

    r = torch.sum(n * diff, dim=-1)  # point-to-plane residual
    J = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)  # (H, W, 6): d r / d (omega, t)
    Jm = J * w[..., None]
    A = torch.einsum("hwi,hwj->ij", Jm, J)
    b = -torch.einsum("hwi,hw->i", Jm, r)
    n_corr = torch.sum(w)
    mean_err = torch.sum(w * r * r) / torch.clamp(n_corr, min=1.0)
    return A, b, n_corr, mean_err


def getab_plan(H: int, W: int) -> int:
    """Blocks of the getAb kernel for an (H, W) source frame: sqrt(H W) / 2,
    rounded up, at most _GETAB_MAX_BLOCKS and at most one a _GETAB_THREADS
    pixels (no block without a pixel). A thread's pixels cost about
    H W / blocks and the fold of the partials about blocks, so the time is
    least near blocks ~ sqrt(H W); the factor 1/2 fits the best of the block
    counts scripts/getab_histogram_geometry.py timed at the three ICP levels
    of a VGA frame (264, 150 and 75 blocks). It depends on the shape alone,
    so a rerun folds the same pixels in the same order and gives the same
    bits."""
    n = H * W
    return max(1, min(-(-math.isqrt(n) // 2), -(-n // _GETAB_THREADS), _GETAB_MAX_BLOCKS))


def _check(name: str, x: torch.Tensor, shape, dtype) -> None:
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(f"icp_getab: {name} is {tuple(x.shape)} {x.dtype}, expected {tuple(shape)} {dtype}")


def icp_getab(T, src_points, src_normals, src_valid, dst_points, dst_normals, dst_valid, intr,
              dist_thresh: float = 0.1, angle_thresh: float = 0.52):
    """The getAb step: (A (6, 6), b (6,), n_corr, mean_err), all on the
    device of the inputs. A CUDA tensor launches the grid_reduce_vec kernel
    once; a CPU tensor takes `icp_getab_plain`."""
    if not use_kernel(src_points):
        return icp_getab_plain(T, src_points, src_normals, src_valid, dst_points, dst_normals, dst_valid,
                               intr, dist_thresh, angle_thresh)
    H, W = src_valid.shape
    Hd, Wd = dst_valid.shape
    f32 = torch.float32
    arrays = (("T", T, (4, 4), f32), ("src_points", src_points, (H, W, 3), f32),
              ("src_normals", src_normals, (H, W, 3), f32), ("src_valid", src_valid, (H, W), torch.bool),
              ("dst_points", dst_points, (Hd, Wd, 3), f32), ("dst_normals", dst_normals, (Hd, Wd, 3), f32),
              ("dst_valid", dst_valid, (Hd, Wd), torch.bool))
    for name, x, shape, dtype in arrays:
        _check(name, x, shape, dtype)
    for name, x, _, _ in arrays:
        if x.device != src_points.device or x.device.type != "cuda":
            raise ValueError(f"icp_getab: {name} is on {x.device}, the kernel takes CUDA tensors on one device")
    if intr.device != src_points.device or intr.dtype != f32 or intr.numel() < 4:
        raise ValueError("icp_getab: intr must be a float32 (9,) on the inputs' device")
    if H * W == 0 or Hd * Wd == 0:
        raise ValueError("icp_getab: empty frame")
    if H * W >= 2 ** 30 or Hd * Wd >= 2 ** 30:
        raise ValueError(f"icp_getab: frames of 2**30 pixels or more ({H}x{W}, {Hd}x{Wd})")
    args = [x.contiguous() for x in (T, intr, src_points, src_normals, src_valid, dst_points, dst_normals,
                                     dst_valid)]
    dev = src_points.device
    out = torch.empty(_RESULT, dtype=f32, device=dev)
    stream = _build.stream_of(out)
    dist2 = float(np.float32(dist_thresh * dist_thresh))
    lib = _build.lib("reduce_vec")
    with _build.on_device(dev):
        _build.check(lib.icp_getab_f32(*(a.data_ptr() for a in args), H * W, Hd, Wd, dist2,
                                       _cos32(angle_thresh), getab_plan(H, W), _scratch_for(dev, stream).data_ptr(),
                                       out.data_ptr(), stream), "icp_getab_f32")
    icp_getab.launches += 1
    return out[:36].view(6, 6), out[36:42], out[42], out[43]


icp_getab.launches = 0
