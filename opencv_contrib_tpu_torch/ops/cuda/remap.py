"""Bilinear remap of C maps by one displacement field: out[c](y, x) =
maps[c](y + dy, x + dx).

Kernel: `csrc/remap.cu`. It replaces the Pallas `remap_bounded`
(opencv_contrib_tpu/ops/pallas/remap.py:41, body :69) and serves the dense
warps of `flow/dis.py::variational_refine` and `flow/tvl1.py::_tvl1_level`
(C = 3: the second frame and its two gradients). Two contracts:

- `max_disp=R` (an int): the Pallas function's. dy and dx are clipped to
  +-R, each corner's index is clamped to the image (edge replicate), and the
  bilinear fractions come from the clipped displacement.
- `max_disp=None`: the flow warp, `ops/image.py::sample_bilinear_multi` at
  the grid plus the displacement. Nothing is clipped; the coordinate is
  clamped to [0, H - 1.001] x [0, W - 1.001].

It is bound by bytes; one thread computes one pixel of all C maps (see the
source). Plain versions beside it: `remap_bounded_plain` and
`remap_flow_plain`. The kernel rounds each product and sum in their order,
so on the card it gives their bits.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops.cuda import _build, use_kernel
from opencv_contrib_tpu_torch.ops.image import grid_coords


def _clamp_limit(n: int) -> float:
    """n - 1.001 computed in double and rounded once to float32, as
    `torch.clamp` (and `jnp.clip`) round a Python float bound: the kernel
    then clamps the last row and column exactly where the plain version
    does."""
    return float(np.float32(n - 1.001))


def _blend(maps, y0, y1, x0, x1, fy, fx) -> torch.Tensor:
    """The four corners of every map, weighted and summed in a fixed order
    (the kernel's): ((w00 v00 + w01 v01) + w10 v10) + w11 v11."""
    H, W = maps.shape[-2:]
    flat = maps.reshape(-1, H * W)

    def at(yi, xi):
        return flat[:, yi * W + xi].reshape(maps.shape)

    gy, gx = 1.0 - fy, 1.0 - fx
    return (gy * gx) * at(y0, x0) + (gy * fx) * at(y0, x1) + (fy * gx) * at(y1, x0) + (fy * fx) * at(y1, x1)


def remap_bounded_plain(maps: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, max_disp: int = 4) -> torch.Tensor:
    """The Pallas `remap_bounded` contract on (C, H, W) or (H, W) maps."""
    H, W = maps.shape[-2:]
    lim = float(int(max_disp))
    dyc, dxc = torch.clamp(dy, -lim, lim), torch.clamp(dx, -lim, lim)
    iy, ix = torch.floor(dyc), torch.floor(dxc)
    y = torch.arange(H, device=maps.device)[:, None] + iy.long()
    x = torch.arange(W, device=maps.device)[None, :] + ix.long()
    return _blend(maps, torch.clamp(y, 0, H - 1), torch.clamp(y + 1, 0, H - 1), torch.clamp(x, 0, W - 1),
                  torch.clamp(x + 1, 0, W - 1), dyc - iy, dxc - ix)


def remap_flow_plain(maps: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """The flow warp: `sample_bilinear_multi` at the grid plus (dy, dx),
    the coordinate clamped to [0, H - 1.001] x [0, W - 1.001]. The four
    weighted corners are summed in the kernel's order, not by a reduction
    over them as `sample_bilinear_multi` sums: a reduction's order is the
    library's choice and differs by an ulp, and TV-L1 carries an ulp to
    tenths of a pixel at the image border (ROADMAP Queue 3)."""
    H, W = maps.shape[-2:]
    y, x = grid_coords(H, W, device=maps.device)
    yc = torch.clamp(y + dy, 0.0, H - 1.001)
    xc = torch.clamp(x + dx, 0.0, W - 1.001)
    y0, x0 = torch.floor(yc).long(), torch.floor(xc).long()
    return _blend(maps, y0, y0 + 1, x0, x0 + 1, yc - y0, xc - x0)


def remap_plain(maps, dy, dx, max_disp: int | None = None) -> torch.Tensor:
    return remap_flow_plain(maps, dy, dx) if max_disp is None else remap_bounded_plain(maps, dy, dx, max_disp)


def remap(maps: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, max_disp: int | None = None) -> torch.Tensor:
    """Remap float32 maps (C, H, W) or (H, W) by dy, dx (H, W): the result
    has the shape of `maps`. `max_disp` an int: the bounded contract; None:
    the flow warp. A CUDA tensor launches the remap kernel; a CPU tensor
    takes the plain version."""
    if not use_kernel(maps):
        return remap_plain(maps, dy, dx, max_disp)
    if maps.ndim not in (2, 3) or maps.dtype != torch.float32:
        raise ValueError(f"remap: the kernel takes float32 (C, H, W) or (H, W) maps, got "
                         f"{tuple(maps.shape)} {maps.dtype}")
    H, W = maps.shape[-2:]
    C = 1 if maps.ndim == 2 else maps.shape[0]
    for name, d in (("dy", dy), ("dx", dx)):
        if tuple(d.shape) != (H, W) or d.dtype != torch.float32 or d.device != maps.device:
            raise ValueError(f"remap: {name} must be a float32 ({H}, {W}) on {maps.device}, got "
                             f"{tuple(d.shape)} {d.dtype} on {d.device}")
    if min(H, W) < 2 or C < 1:
        raise ValueError(f"remap: needs H, W >= 2 and C >= 1, got {C}x{H}x{W}")
    maps, dy, dx = maps.contiguous(), dy.contiguous(), dx.contiguous()
    out = torch.empty_like(maps)
    bounded = max_disp is not None
    lib = _build.lib("remap")
    with torch.cuda.device(maps.device):
        _build.check(lib.remap_f32(maps.data_ptr(), dy.data_ptr(), dx.data_ptr(), out.data_ptr(), C, H, W,
                                   int(bounded), float(int(max_disp)) if bounded else 0.0,
                                   _clamp_limit(H), _clamp_limit(W), _build.stream_of(maps)), "remap_f32")
    remap.launches += 1
    return out


remap.launches = 0
