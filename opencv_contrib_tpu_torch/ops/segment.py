"""Segment sums whose order does not change from run to run.

The JAX package sums per segment with scatter-adds (`.at[ids].add`), which
XLA's CPU backend applies one update after another in index order. On the
card, `index_add_` and `scatter_add_` reach float atomics, whose order moves
the low bits from run to run; a threshold or a comparison on such a sum
(a merge, a label's nearest centre) can then flip between runs.

`segment_sum` takes, on a CUDA tensor, a one-hot product (in the values' dtype) for up to
ONE_HOT_MAX segments (cuBLAS fixes its summation order) and above that
`index_put_(accumulate=True)`, which sorts the ids and adds each segment's
run in order. Both routes give the same bits on a rerun. At the image-structure
methods' inputs on an H100 (`scripts/segment_sum_routes.py`, PERF.md), the
one-hot product takes 0.2-1.0 ms up to 257 segments, where `index_put_`'s
one warp a segment walks runs of up to 300,000 entries (2-80 ms); from
1,440 segments `index_put_` is the faster and the one-hot matrix outgrows
a gigabyte. On the CPU it takes `index_add_`: one update after another in
index order, the JAX version's order, with any number of threads (the CPU's
`index_put_(accumulate=True)` splits the updates over its threads and
changes bits from run to run). Integer counts are exact in any order
(`segment_count`).

Where the ids stay fixed over many sums (the adjoint of a bilinear warp
inside a conjugate-gradient solve, `superres/btv.py`), `segment_plan`
sorts them once, a stable sort, into a padded (n, M) table of each
segment's value indices in index order (one host read of M, when the plan
is made), and `segment_sum_planned` gathers the values through it and adds
its M columns one after another: index order, the order of the CPU's
`index_add_`, on any device, with no atomics and no sort a call."""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

ONE_HOT_MAX = 512


def segment_sum(ids: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """ids (N,) in [0, n), values (N,) or (N, D) float32 or float64 -> the
    sum of the values of each id in their dtype, (n,) or (n, D)."""
    ids = ids.reshape(-1).long()
    dt = torch.float64 if values.dtype == torch.float64 else torch.float32
    v = values.reshape(ids.shape[0], -1).to(dt)
    out = torch.zeros((n, v.shape[1]), dtype=dt, device=ids.device)
    if ids.device.type != "cuda":
        out.index_add_(0, ids, v)
    elif n <= ONE_HOT_MAX:
        one_hot = (ids[:, None] == torch.arange(n, device=ids.device)).to(dt)  # no int64 (N, n) on the way
        with f32_matmul_precision():
            out = one_hot.T @ v
    else:
        out.index_put_((ids,), v, accumulate=True)
    return out.reshape((n,) + tuple(values.shape[1:]))


def segment_count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The number of each id in [0, n) as float32 (n,): integer counts, so
    the same in any order (integer atomics on the card; `torch.bincount`
    would read the largest id on the host)."""
    ids = ids.reshape(-1).long()
    ones = torch.ones_like(ids, dtype=torch.int32)
    return torch.zeros(n, dtype=torch.int32, device=ids.device).scatter_add_(0, ids, ones).to(torch.float32)


class SegmentPlan(NamedTuple):
    slots: torch.Tensor  # (n, M) int64: each segment's value indices in index order, padded with L (a zero)


def segment_plan(ids: torch.Tensor, n: int) -> SegmentPlan:
    """The plan of `segment_sum_planned` for ids (L,) in [0, n)."""
    ids = ids.reshape(-1).long()
    L = ids.shape[0]
    order = torch.sort(ids, stable=True).indices  # index order within each segment
    sid = ids[order]
    counts = torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(0, ids, torch.ones_like(ids))
    M = max(int(counts.max()), 1)  # the one host read
    rank = torch.arange(L, device=ids.device) - (torch.cumsum(counts, 0) - counts)[sid]
    slots = torch.full((n, M), L, dtype=torch.int64, device=ids.device)
    slots[sid, rank] = order
    return SegmentPlan(slots)


def segment_sum_planned(plan: SegmentPlan, values: torch.Tensor) -> torch.Tensor:
    """The sum of the values (L,) of each segment of the plan, (n,), added in
    index order."""
    v = torch.cat([values.reshape(-1), values.new_zeros(1)])
    g = v[plan.slots]  # (n, M)
    acc = g[:, 0]
    for m in range(1, g.shape[1]):
        acc = acc + g[:, m]
    return acc
