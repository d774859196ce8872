"""Fused brute-force 2-NN descriptor matching.

Kernel: `csrc/knn2.cu`. It replaces the Pallas `knn2`
(opencv_contrib_tpu/ops/pallas/matching.py:73, body `_knn2_kernel` :29).
It is bound by operations (2*Q*T*D f32 FMAs on the CUDA cores against
(Q + T) * D inputs); each block keeps a running top-2 of its query tile in
registers while train tiles stream through shared memory, so the Q x T
matrix never reaches device memory. One launch a call: the train set is
split into spans so that about one block runs on each SM, and the block
that finishes a query tile's last span merges the spans (see the source).
The result does not depend on the split.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.features.match import Matches, l2_distance_matrix, top2
from opencv_contrib_tpu_torch.ops.cuda import _build, use_kernel

# the kernel's tile shapes (csrc/knn2.cu Large, Small): (queries, train rows)
_LARGE = (128, 128)
_SMALL = (32, 64)
# Large when the problem has at least this many Large tiles an SM: enough
# that each block streams several train tiles
_LARGE_TILES_PER_SM = 8
# blocks an SM the split aims at, by tile shape
_BLOCKS_PER_SM = {True: 1, False: 4}


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


def plan(Q: int, T: int, sms: int, tile_t: int | None = None):
    """(large, span, n_split) of a launch: the tile shape, the train rows a
    block streams (a multiple of the tile's) and the number of spans. With
    tile_t None the spans are as many as make the blocks about
    _BLOCKS_PER_SM an SM (that many times sms / query tiles, rounded); an
    explicit tile_t sets the span, rounded up to the tile."""
    large = -(-Q // _LARGE[0]) * -(-T // _LARGE[1]) >= _LARGE_TILES_PER_SM * sms
    tq, tt = _LARGE if large else _SMALL
    if tile_t is None:
        span = -(-T // max(1, round(_BLOCKS_PER_SM[large] * sms / -(-Q // tq))))
    else:
        span = max(tile_t, 1)
    span = -(-span // tt) * tt
    return large, span, -(-T // span)


_scratch: dict = {}


def _scratch_for(dev: torch.device, stream: int, q_tiles: int, n_part: int):
    """The tickets (one a query tile, 0 between launches: the merging block
    sets its ticket back) and the spans' partial top-2, made once per device
    and stream and grown when a call needs more: launches on one stream run
    one after another, so no two calls share them at once."""
    tickets, part = _scratch.get((dev, stream), (None, None))
    if tickets is None or tickets.numel() < q_tiles:
        tickets = torch.zeros(max(q_tiles, 256), dtype=torch.int32, device=dev)
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    _scratch[(dev, stream)] = (tickets, part)
    return tickets, part


def knn2(q: torch.Tensor, t: torch.Tensor, tile_q: int = 512, tile_t: int | None = None):
    """Fused 2-NN: q (Q, D), t (T, D) float32 -> (dists (Q, 2), idx (Q,) int32).

    On the card each block streams a span of train rows: `tile_t` rows
    (rounded up to the kernel's train tile) if given, else a split that puts
    about one block on each SM (`plan`); the result has the same bits either
    way. The plain version computes `tile_q` distance rows at a time. Unlike
    the Pallas kernel, neither Q nor T has to be a multiple of a tile.
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
    dev = q.device
    large, span, n_split = plan(Q, T, _build.sm_count(dev), tile_t)
    q_tiles = -(-Q // (_LARGE if large else _SMALL)[0])
    dist = torch.empty((Q, 2), dtype=torch.float32, device=dev)
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    stream = _build.stream_of(q)
    tickets, part = _scratch_for(dev, stream, q_tiles, 3 * n_split * Q)
    lib = _build.lib("knn2")
    with _build.on_device(dev):
        _build.check(lib.knn2_f32(q.data_ptr(), t.data_ptr(), Q, T, D, int(large), span, tickets.data_ptr(),
                                  part.data_ptr(), dist.data_ptr(), idx.data_ptr(), stream), "knn2_f32")
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
