"""Fused brute-force 2-NN descriptor matching.

Kernel: `csrc/knn2.cu`. It replaces the Pallas `knn2`
(opencv_contrib_tpu/ops/pallas/matching.py:73, body `_knn2_kernel` :29).
It is bound by operations (2*Q*T*D f32 FMAs on the CUDA cores against
(Q + T) * D inputs); each block keeps a query tile in shared memory, streams
train tiles through it, and folds distances into a running top-2 in
registers, so the Q x T matrix never reaches device memory (see the source).
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.features.match import Matches, l2_distance_matrix, top2
from opencv_contrib_tpu_torch.ops.cuda import _build, use_kernel

_TILE = 64  # the kernel's query and train tile (csrc/knn2.cu TQ, TT)


def knn2_plain(q: torch.Tensor, t: torch.Tensor, tile_q: int = 512):
    """Plain version: distance rows of tile_q queries at a time, then top-2."""
    tn = torch.sum(t * t, dim=1)
    dists, idxs = [], []
    for s in range(0, q.shape[0], tile_q):
        d = l2_distance_matrix(q[s:s + tile_q], t, tn)
        best, second, a1, _ = top2(d)
        dists.append(torch.stack([best, second], dim=1))
        idxs.append(a1.to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)


def knn2(q: torch.Tensor, t: torch.Tensor, tile_q: int = 512, tile_t: int = 2048):
    """Fused 2-NN: q (Q, D), t (T, D) float32 -> (dists (Q, 2), idx (Q,) int32).

    On the card each block streams `tile_t` train rows (rounded up to the
    kernel's 64-row tile) and the spans' partial top-2 are merged; the query
    tile is the kernel's own 64 rows. The plain version computes `tile_q`
    distance rows at a time. Unlike the Pallas kernel, neither Q nor T has to
    be a multiple of a tile.
    """
    if not use_kernel(q):
        return knn2_plain(q, t, tile_q)
    if t.device != q.device:
        raise ValueError("knn2: q and t must be on one device")
    if q.dtype != torch.float32 or t.dtype != torch.float32:
        raise TypeError("knn2: the CUDA kernel takes float32")
    if q.ndim != 2 or t.ndim != 2 or q.shape[1] != t.shape[1]:
        raise ValueError(f"knn2: shapes {tuple(q.shape)} and {tuple(t.shape)}")
    Q, D = q.shape
    T = t.shape[0]
    if Q == 0 or T == 0 or D == 0 or D > 768:
        raise ValueError(f"knn2: unsupported shape Q={Q} T={T} D={D}")
    q, t = q.contiguous(), t.contiguous()
    span = -(-max(tile_t, 1) // _TILE) * _TILE
    n_split = -(-T // span)
    dev = q.device
    tn = torch.empty(T, dtype=torch.float32, device=dev)
    part_best = torch.empty(n_split * Q, dtype=torch.float32, device=dev)
    part_second = torch.empty_like(part_best)
    part_idx = torch.empty(n_split * Q, dtype=torch.int32, device=dev)
    dist = torch.empty((Q, 2), dtype=torch.float32, device=dev)
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    lib = _build.lib("knn2")
    with torch.cuda.device(dev):
        _build.check(lib.knn2_f32(
            q.data_ptr(), t.data_ptr(), Q, T, D, span, tn.data_ptr(),
            part_best.data_ptr(), part_second.data_ptr(), part_idx.data_ptr(),
            dist.data_ptr(), idx.data_ptr(), _build.stream_of(q)), "knn2_f32")
    knn2.launches += 1
    return dist, idx


knn2.launches = 0


def push_invalid(x: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """Rows where `valid` is False set to 1e6, so that they lose every
    nearest-neighbour comparison against descriptor-sized rows."""
    if valid is None:
        return x
    return torch.where(valid[:, None], x, torch.full_like(x, 1e6))


def ratio_test_match_fused(q, t, q_valid=None, t_valid=None, ratio: float = 0.8, **kw) -> Matches:
    """Fused variant of features.match.ratio_test_match (L2, no
    cross-check): the ratio test runs on the kernel's running top-2."""
    Q = q.shape[0]
    dist, idx = knn2(q, push_invalid(t, t_valid), **kw)
    best, second = dist[:, 0], dist[:, 1]
    ok = (best < ratio * ratio * second) & torch.isfinite(best)
    if q_valid is not None:
        ok = ok & q_valid
    return Matches(
        query_idx=torch.arange(Q, dtype=torch.int32, device=q.device),
        train_idx=idx.to(torch.int32),
        distance=best,
        valid=ok,
    )
