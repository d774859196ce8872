"""One Gaussian pyramid step: the separable [1 4 6 4 1] / 16 blur, then 2x
decimation, (H, W) -> (ceil(H/2), ceil(W/2)).

Kernel: `csrc/pyrdown.cu`. It replaces the Pallas `grid_pyrdown`
(opencv_contrib_tpu/ops/pallas/pipeline.py:87, body :95) and serves
`core/pyramid.py::pyr_down`, which builds every level of the dense-flow
pyramids. One kernel with two borders:

- "reflect101" (BORDER_REFLECT_101): `core/pyramid.py::pyr_down`'s border,
  the one the flow path launches;
- "replicate": the Pallas kernel's border (which needs even H and W; the
  kernel takes any size).

It is bound by bytes; one thread computes one output at its even position
(see the source). Plain versions beside it: `pyr_down_plain`, the
`sep_filter2d` form the CPU runs, and `grid_pyrdown_plain`, the same sum on
a replicate-padded image. The kernel rounds each product and sum as these do,
so on the card it gives their bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.cuda import _build, use_kernel

PYR_TAPS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
BORDERS = {"replicate": 0, "reflect101": 1}  # csrc/pyrdown.cu REPLICATE, REFLECT_101


def pyr_kernel(device=None) -> torch.Tensor:
    return torch.tensor(PYR_TAPS, dtype=torch.float32, device=device)


def pyr_down_plain(x: torch.Tensor) -> torch.Tensor:
    """The reflect-101 step: `sep_filter2d` with the binomial taps, then
    every second row and column."""
    k = pyr_kernel(x.device)
    return filters.sep_filter2d(x, k, k)[::2, ::2]


def grid_pyrdown_plain(x: torch.Tensor) -> torch.Tensor:
    """The replicate step: the same sums on an image edge-padded by 2, whose
    own reflected border falls in the rows and columns cut off after."""
    k = pyr_kernel(x.device)
    p = F.pad(x[None, None], (2, 2, 2, 2), mode="replicate")[0, 0]
    return filters.sep_filter2d(p, k, k)[2:-2:2, 2:-2:2]


def pyrdown_plain(x: torch.Tensor, border: str = "reflect101") -> torch.Tensor:
    return pyr_down_plain(x) if border == "reflect101" else grid_pyrdown_plain(x)


def pyrdown(x: torch.Tensor, border: str = "reflect101") -> torch.Tensor:
    """One pyramid step of (H, W) float32. A CUDA tensor launches the
    pyrdown kernel; a CPU tensor takes the plain version."""
    if border not in BORDERS:
        raise ValueError(f"pyrdown: border must be one of {sorted(BORDERS)}, got {border!r}")
    if not use_kernel(x):
        return pyrdown_plain(x, border)
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"pyrdown: the kernel takes a float32 (H, W), got {tuple(x.shape)} {x.dtype}")
    H, W = x.shape
    if min(H, W) < 3:
        raise ValueError(f"pyrdown: the 5-tap blur needs H, W >= 3, got {H}x{W}")
    x = x.contiguous()
    out = torch.empty(((H + 1) // 2, (W + 1) // 2), dtype=torch.float32, device=x.device)
    lib = _build.lib("pyrdown")
    with _build.on_device(x.device):
        _build.check(lib.pyrdown_f32(x.data_ptr(), out.data_ptr(), H, W, BORDERS[border],
                                     _build.stream_of(x)), "pyrdown_f32")
    pyrdown.launches += 1
    return out


pyrdown.launches = 0
