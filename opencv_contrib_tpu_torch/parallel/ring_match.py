"""Ring all-pairs descriptor matching over a mesh — the port of
opencv_contrib_tpu/parallel/ring_match.py.

The replacement for the reference's all-pairs cross-matching loop
(nRobustViewMatching::computeCrossMatch, libmv/correspondence/
nRobustViewMatching.cc:154, a sequential O(N^2) knnMatch): each rank of the
"sp" axis owns a block of images' descriptors; the blocks travel around the
ring while every rank matches its resident block against the visitor, so
after n_sp steps every (i, j) pair has been matched, with bisection-bandwidth
traffic instead of an all-gather. The block match is plain torch (einsum and
top-k), as the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from opencv_contrib_tpu_torch.parallel.mesh import (all_gather, axis_index, axis_size, check_divisible, mesh_device,
                                                    ppermute_start)
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls


def _pair_match_block(q_desc, q_valid, t_desc, t_valid, ratio: float):
    """2-NN ratio-test matching of every query image in the block against
    every train image: q_desc (Bq, K, D), t_desc (Bt, K, D) -> best train
    idx (Bq, Bt, K) int32, its distance (Bq, Bt, K) and valid (Bq, Bt, K)."""
    d = (torch.sum(q_desc * q_desc, dim=-1)[:, None, :, None]
         + torch.sum(t_desc * t_desc, dim=-1)[None, :, None, :]
         - 2.0 * torch.einsum("qkd,tld->qtkl", q_desc, t_desc))
    d = torch.where(t_valid[None, :, None, :], d, torch.full_like(d, float("inf")))
    neg, idx = torch.topk(-d, 2, dim=-1)  # (Bq, Bt, K, 2)
    best, second = -neg[..., 0], -neg[..., 1]
    ok = q_valid[:, None, :] & (best < ratio * ratio * second) & torch.isfinite(best)
    return idx[..., 0].to(torch.int32), best, ok


@f32_matmuls
def ring_all_pairs_match(descs, valids, mesh: DeviceMesh, ratio: float = 0.8):
    """All-pairs matching of N images sharded over the mesh's sp axis.

    descs (N, K, D) float32, valids (N, K) bool, the same on every rank, N
    divisible by the sp extent. Returns (train_idx (N, N, K), dist (N, N, K),
    valid (N, N, K)) on every rank, where entry [i, j] holds matches of image
    i's descriptors into image j. The next visitor's transfer is posted
    before the current block is matched (the JAX package's double
    buffering), and its wait comes after the match.
    """
    dev = mesh_device(mesh)
    descs = torch.as_tensor(descs).to(dev, torch.float32)
    valids = torch.as_tensor(valids).to(dev, torch.bool)
    n_sp = axis_size(mesh, "sp")
    B = check_divisible(descs.shape[0], mesh, "sp", "images")
    my = axis_index(mesh, "sp")
    d_block, v_block = descs[my * B:(my + 1) * B].contiguous(), valids[my * B:(my + 1) * B].contiguous()
    N, K = descs.shape[0], descs.shape[1]
    out_idx = torch.zeros((B, N, K), dtype=torch.int32, device=dev)
    out_dist = torch.full((B, N, K), float("inf"), device=dev)
    out_ok = torch.zeros((B, N, K), dtype=torch.bool, device=dev)
    vis_d, vis_v = d_block, v_block
    for s in range(n_sp):
        src = (my - s) % n_sp  # which shard's block is visiting
        last = s == n_sp - 1
        if not last:  # post the ring transfer of the next visitor first
            nxt_d, wait_d = ppermute_start(vis_d, mesh, "sp")
            nxt_v, wait_v = ppermute_start(vis_v.to(torch.uint8), mesh, "sp")
        idx, dist, ok = _pair_match_block(d_block, v_block, vis_d, vis_v, ratio)
        out_idx[:, src * B:(src + 1) * B] = idx
        out_dist[:, src * B:(src + 1) * B] = dist
        out_ok[:, src * B:(src + 1) * B] = ok
        if not last:
            vis_d, vis_v = wait_d(), wait_v().to(torch.bool)
    # every rank returns the global arrays: gather the row blocks over sp
    return (all_gather(out_idx, mesh, "sp"), all_gather(out_dist, mesh, "sp"),
            all_gather(out_ok.to(torch.uint8), mesh, "sp").to(torch.bool))


@f32_matmuls
def all_pairs_match_reference(descs, valids, ratio: float = 0.8):
    """Single-device reference implementation (for parity tests)."""
    return _pair_match_block(descs, valids, descs, valids, ratio)
