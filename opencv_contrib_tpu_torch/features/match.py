"""Brute-force descriptor matching: 2-NN, Lowe ratio test and mutual
cross-check, for float descriptors (squared L2) and +-1-encoded binary
descriptors (Hamming), the pairwise sweep over many images, and the GMS and
LOGOS match filters (the port of opencv_contrib_tpu/features/match.py).

On a CPU tensor `ratio_test_match` forms the full (Q, T) distance matrix
with one float32 matrix product and takes its row-wise top-2 and
column-wise argmin, as the JAX version does; so does the Hamming metric on
the card, whose product of +-1 entries is exact in full f32. For L2 on a
CUDA tensor it never forms that matrix: the fused 2-NN kernel
(`ops.cuda.matching.knn2`) gives each query's top-2, and a second launch
with the roles swapped gives each train row's nearest query for the
cross-check.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops.cuda import use_kernel
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls

METRICS = ("l2", "hamming")


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


@f32_matmuls
def hamming_distance_matrix(q_signs: torch.Tensor, t_signs: torch.Tensor) -> torch.Tensor:
    """Hamming distances (Q, T) of +-1-encoded bit vectors: (D - q.t) / 2.
    The product runs in full f32 (no TF32), where sums of +-1 are exact."""
    D = q_signs.shape[-1]
    return 0.5 * (D - q_signs @ t_signs.T)


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


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r}: expected one of {METRICS}")


def _masked_distances(q, t, t_valid, metric):
    d = l2_distance_matrix(q, t) if metric == "l2" else hamming_distance_matrix(q, t)
    if t_valid is not None:
        d = torch.where(t_valid[None, :], d, torch.full_like(d, float("inf")))
    return d


def knn2(q: torch.Tensor, t: torch.Tensor, q_valid=None, t_valid=None, metric: str = "l2"):
    """2-NN search, squared L2 or Hamming: (dists (Q, 2), idx (Q, 2))."""
    _check_metric(metric)
    d = _masked_distances(q, t, t_valid, metric)
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
    """Lowe ratio test with optional mutual cross-check: on squared L2 the
    ratio is squared, on Hamming it is taken as it is. Ties go to the lower
    index. Returns one slot per query row."""
    _check_metric(metric)
    Q = q.shape[0]
    dev = q.device
    if q_valid is None:
        q_valid = torch.ones(Q, dtype=torch.bool, device=dev)
    if t_valid is None:
        t_valid = torch.ones(t.shape[0], dtype=torch.bool, device=dev)
    arange = torch.arange(Q, dtype=torch.int32, device=dev)

    if metric == "l2" and use_kernel(q):
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

    d = _masked_distances(q, t, t_valid, metric)
    best, second, nn, _ = top2(d)
    bound = ratio * ratio * second if metric == "l2" else ratio * second
    ok = q_valid & (best < bound) & torch.isfinite(best)
    if cross_check:
        dT = torch.where(q_valid[:, None], d, torch.full_like(d, float("inf")))
        back = torch.argmin(dT, dim=0)  # for each train row, its best query
        ok = ok & (back[nn] == arange)
    return Matches(query_idx=arange, train_idx=nn.to(torch.int32), distance=best, valid=ok)


def gms_filter(matches: Matches, xy1: torch.Tensor, xy2: torch.Tensor, shape1=(480, 640), shape2=(480, 640),
               grid: int = 20, tau_factor: float = 6.0) -> Matches:
    """Grid Motion Statistics (cv::xfeatures2d::matchGMS): a match is kept
    when the matches of the 3x3 cells around its source cell that move to
    the same offset cells around its target cell outnumber tau_factor *
    sqrt(mean support). The votes are 0/1 counts, so the accumulating
    scatter sums them exactly in any order."""
    H1, W1 = shape1
    H2, W2 = shape2
    G = grid

    def cell_of(xy, H, W):
        cx = torch.clamp((xy[:, 0] / W * G).to(torch.int32), 0, G - 1)
        cy = torch.clamp((xy[:, 1] / H * G).to(torch.int32), 0, G - 1)
        return (cy * G + cx).long()

    c1 = cell_of(xy1[matches.query_idx.long()], H1, W1)
    c2 = cell_of(xy2[matches.train_idx.long()], H2, W2)
    w = matches.valid.to(torch.float32)
    dev = w.device
    votes = torch.zeros(G * G, G * G, device=dev).index_put_((c1, c2), w, accumulate=True)
    votes4 = votes.reshape(G, G, G, G)
    n_cell = torch.zeros(G * G, device=dev).index_put_((c1,), w, accumulate=True).reshape(G, G)
    supp4 = torch.zeros_like(votes4)
    n_nb = torch.zeros_like(n_cell)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            supp4 = supp4 + torch.roll(votes4, (dy, dx, dy, dx), dims=(0, 1, 2, 3))
            n_nb = n_nb + torch.roll(n_cell, (dy, dx), dims=(0, 1))
    c1y, c1x = c1 // G, c1 % G
    c2y, c2x = c2 // G, c2 % G
    support = supp4[c1y, c1x, c2y, c2x]
    tau = tau_factor * torch.sqrt(torch.clamp(n_nb[c1y, c1x], min=1.0) / 9.0)
    return matches._replace(valid=matches.valid & (support > tau))


def gms_filter_auto(matches: Matches, xy1, xy2, shape1=(480, 640), shape2=(480, 640),
                    tau_factor: float = 6.0) -> Matches:
    """GMS with the grid from the match count: G ~ sqrt(n / 4) in [8, 32],
    about 4 matches a cell. Reading the count is one host sync."""
    n = int(torch.sum(matches.valid))
    grid = int(np.clip(int(np.sqrt(max(n, 1) / 4.0)), 8, 32))
    return gms_filter(matches, xy1, xy2, shape1=shape1, shape2=shape2, grid=grid, tau_factor=tau_factor)


def match_pairs_batched(descs: torch.Tensor, valids: torch.Tensor, pairs, ratio: float = 0.8) -> Matches:
    """Match many image pairs: descs (N, K, D), valids (N, K), pairs (Np, 2)
    -> Matches with a leading dimension Np. The pairs run one after another
    through `ratio_test_match` (for L2 on the card, two knn2 launches a
    pair); the pair list is read on the host once."""
    pairs = torch.as_tensor(pairs).reshape(-1, 2).tolist()
    ms = [ratio_test_match(descs[i], descs[j], valids[i], valids[j], ratio=ratio) for i, j in pairs]
    return Matches(*(torch.stack(f) for f in zip(*ms)))


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis as `jnp.median` takes it: the middle value,
    or for an even count the mean of the two middle ones."""
    v = torch.sort(x, dim=-1).values
    k = x.shape[-1]
    return (v[..., (k - 1) // 2] + v[..., k // 2]) * 0.5


def logos_filter(matches: Matches, xy1: torch.Tensor, xy2: torch.Tensor, k: int = 5, min_support: int = 2,
                 pos_tol: float = 0.25) -> Matches:
    """LOGOS-style local geometric support (matchLOGOS): a match survives
    when at least `min_support` of its k nearest neighbours in image 1 move
    by a similarity (the complex ratio of the relative displacements) within
    pos_tol of both its own and the neighbour's median. The neighbours are
    the k smallest distances, ties to the lower index (the order of
    `lax.top_k(-d1, k)`), through a stable sort."""
    Q = xy1.shape[0]
    valid = matches.valid
    d1 = ((xy1[:, None] - xy1[None]) ** 2).sum(-1)
    exclude = torch.eye(Q, dtype=torch.bool, device=d1.device) | ~valid[None]
    d1 = torch.where(exclude, torch.inf, d1)
    nbr = torch.sort(d1, dim=1, stable=True).indices[:, :k]

    p2 = xy2[matches.train_idx.long()]
    rel1 = xy1[nbr] - xy1[:, None]
    rel2 = p2[nbr] - p2[:, None]
    n1sq = torch.clamp((rel1 * rel1).sum(-1), min=1e-12)
    re = (rel2[..., 0] * rel1[..., 0] + rel2[..., 1] * rel1[..., 1]) / n1sq
    im = (rel2[..., 1] * rel1[..., 0] - rel2[..., 0] * rel1[..., 1]) / n1sq
    med_re, med_im = _median(re), _median(im)
    med_mag = torch.clamp(torch.sqrt(med_re ** 2 + med_im ** 2), min=1e-6)
    dev_q = torch.sqrt((re - med_re[:, None]) ** 2 + (im - med_im[:, None]) ** 2)
    dev_n = torch.sqrt((re - med_re[nbr]) ** 2 + (im - med_im[nbr]) ** 2)
    consistent = valid[nbr] & (dev_q < pos_tol * med_mag[:, None]) & (dev_n < pos_tol * med_mag[nbr])
    return matches._replace(valid=valid & (consistent.sum(1) >= min_support))
