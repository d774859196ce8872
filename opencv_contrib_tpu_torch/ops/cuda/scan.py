"""Prefix-sum kernels for summed-area tables: `grid_scan` (inclusive row
scan), `integral_image` (inclusive 2D scan, no zero row) and
`integral_padded` (the zero-padded (H + 1, W + 1) table of
`ops.integral.integral`).

Kernel: `csrc/scan.cu`. It replaces the Pallas `integral_image`
(opencv_contrib_tpu/ops/pallas/grid.py:282, body `_scan_rows_kernel` :260)
and `grid_scan` (ops/pallas/pipeline.py:35). It is bound by bytes (one add
per element against 8 bytes moved); the TPU kernels' carried scratch prefix
becomes a warp-per-row scan with the carry in a register. `grid_scan` is
a row scan of its own: the warp stages a pass of the row in shared memory,
a lane scans a run of it in registers and the warp joins the 32 run totals
in one shuffle scan a pass, in a grid that `scan_plan` sizes to the card;
the 2D scan is one launch of slabs of rows and
columns, each adding the column totals of the slabs above it and the row
totals of those to its left in a fixed order (see the source); it takes any
width, and it writes the padded table itself, so `integral` is one launch a
frame. Both integral wrappers also take a batch (N, H, W) of tables of one
size, in one launch (MIL's and Boosting's Haar patches): the kernel numbers
its slab tickets table-major, and each table's bits equal those of a launch
on it alone. Tables small enough (`one_block`: the 32 x 32 patches) take a
second kernel in the same source, one block a table, which sums in the
slab kernel's order on the slabs of (H, W) and so gives its bits.

The plain versions sum in the order of XLA's CPU cumsum (blocks of 16,
sequential inside a block, the block totals scanned the same way), so on
the CPU the port's summed-area table is bit-identical to the JAX package's.
That matters downstream: a VGA table reaches ~4e7, where one float32 ulp is
4, and the detector's box sums are differences of four such entries. The
kernel's order is its own but fixed by (H, W): a rerun gives the same bits.
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
    """Columns, then rows: the order of the JAX package's `ops.integral`;
    (..., H, W), each table on its own."""
    x = x.to(torch.float32)
    return _scan_last(_scan_last(x.transpose(-1, -2)).transpose(-1, -2))


def _check(x: torch.Tensor, name: str, batch: bool = False) -> None:
    if x.ndim not in ((2, 3) if batch else (2,)) or 0 in x.shape:
        raise ValueError(f"{name}: expected a non-empty (H, W){' or (N, H, W)' if batch else ''}, "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {x.dtype}")


_SCAN_WARPS = 8  # csrc/scan.cu SCAN_WARPS: rows a block at most
_RUNS = (4, 8, 16, 32)  # floats a lane holds: a pass covers 32 of them


def scan_plan(H: int, W: int, sms: int) -> tuple[int, int]:
    """(warps, run) of a grid_scan launch: one warp a row, `warps` rows a
    block, as many as still give a block to each of `sms` SMs (1 where the
    rows are fewer than the SMs: a block a row); `run` floats a lane, the
    fewest whose pass of 32 covers the row, else 32 (passes of 1,024
    columns). The sums' order depends on W alone, through `run`."""
    warps = next((w for w in (_SCAN_WARPS, 4, 2) if -(-H // w) >= sms), 1)
    return warps, next((r for r in _RUNS if 32 * r >= W), _RUNS[-1])


def grid_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis of (H, W)."""
    if not use_kernel(x):
        return grid_scan_plain(x)
    _check(x, "grid_scan")
    x = x.contiguous()
    H, W = x.shape
    out = torch.empty_like(x)
    warps, run = scan_plan(H, W, _build.sm_count(x.device))
    lib = _build.lib("scan")
    with _build.on_device(x.device):
        _build.check(lib.scan_rows_f32(x.data_ptr(), out.data_ptr(), H, W, warps, run,
                                       _build.stream_of(x)), "scan_rows_f32")
    grid_scan.launches += 1
    return out


def integral_padded_plain(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> the zero-padded tables (..., H + 1, W + 1)."""
    return F.pad(integral_image_plain(x), (1, 0, 1, 0))


_BANDS = 48  # integral: about this many bands of rows (scripts/integral_geometry.py: 32, 40 and 56 were slower)
_COLS = 1024  # csrc/scan.cu MAX_COLS: columns a slab
_MIN_COLS = 128  # a slab's columns may shrink to this to keep about _BANDS bands
_MIN_ROWS = 8  # rows a band at least: a short image takes fewer bands, not bands of a row or two
_GROUPS = 4  # csrc/scan.cu GROUPS: rows of group sums beside the slab
_SMEM_MAX = 200 * 1024  # csrc/scan.cu MAX_SMEM: a slab's rows, E, the group sums and the row carries
_EPOCHS = 1 << 31  # launches a scratch serves (a status holds the epoch in 32 bits)
_TABLE_SMEM = 48 * 1024  # csrc/scan.cu TABLE_SMEM: a one-block table's bands, totals and E


def slabs(H: int, W: int) -> tuple[int, int]:
    """(R, Cw): the integral kernel's slabs of R rows by Cw columns (a
    multiple of 4). About _BANDS bands of at least _MIN_ROWS rows, so a
    slab reads the totals of at most about _BANDS slabs above it; as
    many columns as then fit in the shared memory beside E, the group sums
    and the row carries, up to _COLS, and the fewest slabs across of that
    width, as even as that allows. Only past about 18,000 rows (a slab of
    _MIN_COLS columns) does the band count grow. The table's bits depend on
    (R, Cw), so they depend on (H, W) alone."""
    words = _SMEM_MAX // 4
    R = min(max(-(-H // _BANDS), _MIN_ROWS, 1), (words - (1 + _GROUPS) * _MIN_COLS) // (_MIN_COLS + 1))
    widest = min(_COLS, (words - R) // (R + 1 + _GROUPS) // 4 * 4)
    nc = -(-W // widest)
    return R, -(-W // (4 * nc)) * 4


def one_block(H: int, W: int) -> bool:
    """Whether the integral kernel takes tables of (H, W) one block a table
    (`integral_table_kernel`): one slab across, and the slabs' rows, band
    totals and E within _TABLE_SMEM. Its bits equal the slab kernel's."""
    R, Cw = slabs(H, W)
    return W <= Cw and (H + 2 * -(-H // R)) * Cw * 4 <= _TABLE_SMEM


class _Scratch:
    """The integral kernel's control words (the slab ticket, then two
    statuses a slab) and its slabs' column and row totals, for one device
    and stream. The kernel sets nothing back: each launch draws its tickets
    from `base` on and marks its statuses with its `epoch`, and both count
    on here. Launches on one stream run one after another, so no two share
    it at once."""

    def __init__(self, dev: torch.device, n_ctrl: int, n_tot: int, n_rtot: int):
        self.ctrl = torch.zeros(n_ctrl, dtype=torch.int32, device=dev)
        self.tot = torch.empty(n_tot, dtype=torch.float32, device=dev)
        self.rtot = torch.empty(n_rtot, dtype=torch.float32, device=dev)
        self.base, self.epoch = 0, 0

    def next(self, tickets: int) -> tuple[int, int]:
        """(base, epoch) of the next launch, which draws `tickets`, as the C
        ints that carry their 32 bits."""
        base, self.base, self.epoch = self.base, (self.base + tickets) % (1 << 32), self.epoch + 1
        return base - (1 << 32) if base >= 1 << 31 else base, self.epoch


_scratch: dict = {}


def _scratch_for(dev: torch.device, stream: int, n_ctrl: int, n_tot: int, n_rtot: int) -> _Scratch:
    sc = _scratch.get((dev, stream))
    if (sc is None or sc.ctrl.numel() < n_ctrl or sc.tot.numel() < n_tot or sc.rtot.numel() < n_rtot
            or sc.epoch >= _EPOCHS - 1):
        sc = _scratch[(dev, stream)] = _Scratch(dev, n_ctrl, n_tot, n_rtot)
    return sc


def _integral(x: torch.Tensor, pad: int, name: str, slabs_only: bool = False) -> torch.Tensor:
    """One launch of the integral kernel on (H, W) or (N, H, W): one block
    a table where `one_block` allows it (unless `slabs_only`), else the
    slab tickets."""
    x = x.to(torch.float32)
    _check(x, name, batch=True)
    x = x.contiguous()
    N, (H, W) = (x.shape[0] if x.ndim == 3 else 1), x.shape[-2:]
    out = torch.empty(x.shape[:-2] + (H + pad, W + pad), dtype=torch.float32, device=x.device)
    R, Cw = slabs(H, W)
    stream = _build.stream_of(x)
    if not slabs_only and one_block(H, W):
        with _build.on_device(x.device):
            _build.check(_build.lib("scan").integral_table_f32(x.data_ptr(), out.data_ptr(), N, H, W, W + pad, pad,
                                                               R, Cw, stream), "integral_table_f32")
        integral_image.launches += 1
        return out
    n = N * -(-H // R) * -(-W // Cw)
    sc = _scratch_for(x.device, stream, 1 + 2 * n, n * Cw, n * R)
    base, epoch = sc.next(n)
    lib = _build.lib("scan")
    with _build.on_device(x.device):
        err = lib.integral_f32(x.data_ptr(), out.data_ptr(), N, H, W, W + pad, pad, R, Cw, sc.ctrl.data_ptr(), base,
                               epoch, sc.tot.data_ptr(), sc.rtot.data_ptr(), stream)
    if err != 0:  # a launch refused drew no tickets: the counts here no longer match the ticket
        _scratch.pop((x.device, stream), None)
    _build.check(err, "integral_f32")
    integral_image.launches += 1
    return out


def integral_image(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum (H, W) -> (H, W) float32, no zero row: one
    launch of the integral kernel on a CUDA tensor (a batch (N, H, W) too)."""
    if not use_kernel(x):
        return integral_image_plain(x)
    return _integral(x, 0, "integral_image")


def integral_padded(x: torch.Tensor) -> torch.Tensor:
    """The zero-padded summed-area table (H + 1, W + 1) float32,
    out[i, j] = sum(x[:i, :j]): one launch of the integral kernel, which
    writes the zero row and column itself; on a CPU tensor, the plain table
    padded. A batch (N, H, W) gives (N, H + 1, W + 1), also in one launch."""
    if not use_kernel(x):
        return integral_padded_plain(x)
    return _integral(x, 1, "integral_padded")


grid_scan.launches = 0
integral_image.launches = 0  # both integral wrappers count the one kernel
