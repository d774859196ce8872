"""Prefix-sum kernels for summed-area tables: `grid_scan` (inclusive row
scan) and `integral_image` (inclusive 2D scan, no zero row).

Kernel: `csrc/scan.cu`. It replaces the Pallas `integral_image`
(opencv_contrib_tpu/ops/pallas/grid.py:282, body `_scan_rows_kernel` :260)
and `grid_scan` (ops/pallas/pipeline.py:35). It is bound by bytes (one add
per element against 8 bytes moved); the TPU kernels' carried scratch prefix
becomes a warp-per-row scan with the carry in a register, and the columns
pass is a second launch with coalesced loads (see the source). One row-scan
kernel serves both wrappers: `integral_image` is `grid_scan`, then the
column scan.

The plain versions sum in the order of XLA's CPU cumsum (blocks of 16,
sequential inside a block, the block totals scanned the same way), so on
the CPU the port's summed-area table is bit-identical to the JAX package's.
That matters downstream: a VGA table reaches ~4e7, where one float32 ulp is
4, and the detector's box sums are differences of four such entries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops.cuda import _build, use_kernel

_BLOCK = 16  # XLA's CPU cumsum block


def _scan_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along the last axis, summed as XLA's CPU cumsum sums."""
    n = x.shape[-1]
    m = -(-n // _BLOCK)
    blocks = F.pad(x, (0, m * _BLOCK - n)).reshape(*x.shape[:-1], m, _BLOCK)
    inner = blocks.clone()
    for k in range(1, min(n, _BLOCK)):  # sequential inside each block
        inner[..., k] = inner[..., k - 1] + blocks[..., k]
    if m == 1:
        return inner.reshape(*x.shape[:-1], _BLOCK)[..., :n]
    carry = F.pad(_scan_last(inner[..., -1])[..., :-1], (1, 0))  # exclusive
    return (inner + carry[..., None]).reshape(*x.shape[:-1], m * _BLOCK)[..., :n]


def grid_scan_plain(x: torch.Tensor) -> torch.Tensor:
    return _scan_last(x)


def integral_image_plain(x: torch.Tensor) -> torch.Tensor:
    """Columns, then rows: the order of the JAX package's `ops.integral`."""
    x = x.to(torch.float32)
    return _scan_last(_scan_last(x.T).T)


def _check(x: torch.Tensor, name: str) -> None:
    if x.ndim != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{name}: expected a non-empty (H, W), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {x.dtype}")


def grid_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis of (H, W)."""
    if not use_kernel(x):
        return grid_scan_plain(x)
    _check(x, "grid_scan")
    x = x.contiguous()
    H, W = x.shape
    out = torch.empty_like(x)
    lib = _build.lib("scan")
    with _build.on_device(x.device):
        _build.check(lib.scan_rows_f32(x.data_ptr(), out.data_ptr(), H, W,
                                       _build.stream_of(x)), "scan_rows_f32")
    grid_scan.launches += 1
    return out


def integral_image(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum (H, W) -> (H, W) float32, no zero row: the
    row scan of `grid_scan`, then a column scan."""
    if not use_kernel(x):
        return integral_image_plain(x)
    x = x.to(torch.float32)
    _check(x, "integral_image")
    rows = grid_scan(x)
    H, W = rows.shape
    out = torch.empty_like(rows)
    lib = _build.lib("scan")
    with _build.on_device(x.device):
        _build.check(lib.scan_cols_f32(rows.data_ptr(), out.data_ptr(), H, W,
                                       _build.stream_of(x)), "scan_cols_f32")
    integral_image.launches += 1
    return out


grid_scan.launches = 0
integral_image.launches = 0
