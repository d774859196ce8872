"""Brute-force descriptor matching: 2-NN, Lowe ratio test and mutual
cross-check — the port of opencv_contrib_tpu/features/match.py's L2
matcher.

On a CPU tensor `ratio_test_match` forms the full (Q, T) distance matrix
with one float32 matrix product and takes its row-wise top-2 and
column-wise argmin, as the JAX version does. On a CUDA tensor it never
forms that matrix: the fused 2-NN kernel (`ops.cuda.matching.knn2`) gives
each query's top-2, and a second launch with the roles swapped gives each
train row's nearest query for the cross-check.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.ops.cuda import use_kernel


class Matches(NamedTuple):
    query_idx: torch.Tensor  # (M,) int32
    train_idx: torch.Tensor  # (M,) int32
    distance: torch.Tensor  # (M,) float32
    valid: torch.Tensor  # (M,) bool


def l2_distance_matrix(q: torch.Tensor, t: torch.Tensor, tn: torch.Tensor | None = None) -> torch.Tensor:
    """Squared L2 distances (Q, T) via one matmul; tn = |t|^2 if known."""
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    if tn is None:
        tn = torch.sum(t * t, dim=-1)
    return qn + tn[None, :] - 2.0 * (q @ t.T)


def top2(d: torch.Tensor):
    """Row-wise two smallest of d (Q, T): (best, second, best_idx,
    second_idx). Ties go to the lower column and the second excludes only
    the best's column: the order `jax.lax.top_k(-d, 2)` gives."""
    a1 = torch.argmin(d, dim=1, keepdim=True)
    best = torch.gather(d, 1, a1)[:, 0]
    d2 = d.scatter(1, a1, float("inf"))
    a2 = torch.argmin(d2, dim=1, keepdim=True)
    second = torch.gather(d2, 1, a2)[:, 0]
    return best, second, a1[:, 0], a2[:, 0]


def _masked_l2(q, t, t_valid):
    d = l2_distance_matrix(q, t)
    if t_valid is not None:
        d = torch.where(t_valid[None, :], d, torch.full_like(d, float("inf")))
    return d


def knn2(q: torch.Tensor, t: torch.Tensor, q_valid=None, t_valid=None):
    """2-NN search (L2): (dists (Q, 2), idx (Q, 2))."""
    d = _masked_l2(q, t, t_valid)
    best, second, a1, a2 = top2(d)
    dist = torch.stack([best, second], dim=1)
    if q_valid is not None:
        dist = torch.where(q_valid[:, None], dist, torch.full_like(dist, float("inf")))
    return dist, torch.stack([a1, a2], dim=1).to(torch.int32)


def ratio_test_match(
    q: torch.Tensor,
    t: torch.Tensor,
    q_valid: torch.Tensor | None = None,
    t_valid: torch.Tensor | None = None,
    ratio: float = 0.8,
    metric: str = "l2",
    cross_check: bool = True,
) -> Matches:
    """Lowe ratio test on squared L2 (ratio^2) with optional mutual
    cross-check. Returns one slot per query row."""
    if metric != "l2":
        raise ValueError(f"ratio_test_match: metric {metric!r} is not ported (only 'l2')")
    Q = q.shape[0]
    dev = q.device
    if q_valid is None:
        q_valid = torch.ones(Q, dtype=torch.bool, device=dev)
    if t_valid is None:
        t_valid = torch.ones(t.shape[0], dtype=torch.bool, device=dev)
    arange = torch.arange(Q, dtype=torch.int32, device=dev)

    if use_kernel(q):
        from opencv_contrib_tpu_torch.ops.cuda import matching as fused

        dist, nn = fused.knn2(q, fused.push_invalid(t, t_valid))
        best, second = dist[:, 0], dist[:, 1]
        nn_l = nn.long()
        # a pushed-out row can only win when no train row is valid: that
        # query has no match, as in the masked-matrix form
        ok = q_valid & t_valid[nn_l] & (best < ratio * ratio * second) & torch.isfinite(best)
        if cross_check:
            _, back = fused.knn2(t, fused.push_invalid(q, q_valid))
            ok = ok & (back[nn_l] == arange)
        return Matches(query_idx=arange, train_idx=nn, distance=best, valid=ok)

    d = _masked_l2(q, t, t_valid)
    best, second, nn, _ = top2(d)
    ok = q_valid & (best < ratio * ratio * second) & torch.isfinite(best)
    if cross_check:
        dT = torch.where(q_valid[:, None], d, torch.full_like(d, float("inf")))
        back = torch.argmin(dT, dim=0)  # for each train row, its best query
        ok = ok & (back[nn] == arange)
    return Matches(query_idx=arange, train_idx=nn.to(torch.int32), distance=best, valid=ok)
