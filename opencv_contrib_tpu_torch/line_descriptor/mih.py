"""BinaryDescriptorMatcher: multi-index hashing over binary LBD codes (the
port of opencv_contrib_tpu/line_descriptor/mih.py).

Reference anchor: line_descriptor/src/binary_descriptor_matcher.cpp
(Norouzi et al. multi-index hashing): a B-bit code is split into m
substrings; a query probes each substring's bucket, and by pigeonhole any
code within Hamming radius r < m collides exactly in at least one table.
Candidates are verified by their exact Hamming distance.

Tables are dense (m, 2^b, cap) int32 bucket arrays built by a stable sort;
a query's probe is one gather, its verification XOR and popcount over the
candidates, then the k nearest by a stable sort.

The twin's codes are uint32; here they are int32 words with the same bits
(as `features.describe`'s packed codes): a substring is masked after its
shift, since `>>` of a negative int32 shifts the sign in, and the packing
sums in int64 and wraps to int32, so a word with bit 31 set keeps it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.stereo.matching import _popcount32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 words of the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def lbd_binarize(desc: torch.Tensor) -> torch.Tensor:
    """Binarize float LBD descriptors (N, D) into packed words (N,
    ceil(D (D-1) / 2 / 32)) int32: bit p of the code is desc[i] > desc[j]
    for the p-th pair i < j (row-major), little-endian in each word
    (BinaryDescriptor's binary LBD stage)."""
    N, D = desc.shape
    ii, jj = torch.triu_indices(D, D, 1, device=desc.device)
    bits = (desc[:, ii] > desc[:, jj]).to(torch.int64)  # (N, P)
    P = bits.shape[1]
    bits = torch.nn.functional.pad(bits, (0, (-P) % 32)).reshape(N, -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    return _wrap32((bits << shifts).sum(-1))


class MIHIndex(NamedTuple):
    buckets: torch.Tensor  # (m, 2^b, cap) int32 code ids, -1 = empty
    codes: torch.Tensor  # (N, n_words) int32 database codes
    b: int  # substring bits (8)


def _substrings(codes: torch.Tensor, b: int = 8) -> torch.Tensor:
    """(N, n_words) int32 -> (N, m) b-bit substring keys, word-major."""
    per = 32 // b
    mask = (1 << b) - 1
    subs = [(codes >> (b * k)) & mask for k in range(per)]
    return torch.stack(subs, -1).reshape(codes.shape[0], -1)


def mih_build(codes: torch.Tensor, b: int = 8, cap: int = 32) -> MIHIndex:
    """Build the multi-index (BinaryDescriptorMatcher::add + train)."""
    return MIHIndex(buckets=_mih_build(codes, b, cap), codes=codes, b=b)


def _mih_build(codes: torch.Tensor, b: int, cap: int) -> torch.Tensor:
    """Sort-based bucket fill, all tables at once: each table's ids sorted
    stably by key, and each bucket's first `cap` written (the reference's
    buckets are unbounded; cap trades recall for a static shape).

    The twin scatters every id to slot min(rank, cap - 1) and writes -1 for
    a rank past cap; the CPU's scatter applies its updates in order, so in a
    bucket that overflows the last -1 lands on slot cap - 1. That is kept:
    such a bucket holds its first cap - 1 ids."""
    N = codes.shape[0]
    dev = codes.device
    keys = _substrings(codes, b).T.contiguous().long()  # (m, N)
    m = keys.shape[0]
    n_buckets = 1 << b
    sk, order = torch.sort(keys, dim=1, stable=True)
    first = torch.searchsorted(sk, torch.arange(n_buckets, device=dev).expand(m, n_buckets).contiguous())
    count = torch.diff(first, dim=1, append=torch.full((m, 1), N, device=dev))  # (m, n_buckets)
    rank = torch.arange(N, device=dev) - torch.gather(first, 1, sk)
    n_of = torch.gather(count, 1, sk)
    kept = rank < cap
    ids = torch.where(kept & ~((rank == cap - 1) & (n_of > cap)), order, -1).to(torch.int32)
    slot = torch.where(kept, sk * cap + rank, n_buckets * cap)  # past the table: dropped
    tbl = torch.full((m, n_buckets * cap + 1), -1, dtype=torch.int32, device=dev)
    tbl.scatter_(1, slot, ids)  # every kept slot is written once
    return tbl[:, :-1].reshape(m, n_buckets, cap)


def mih_knn_match(index: MIHIndex, queries: torch.Tensor, k: int = 2):
    """kNN match with exact-Hamming verification of the probed candidates
    (BinaryDescriptorMatcher::knnMatch). Returns (idx (Q, k), dist (Q, k));
    unfilled slots have idx -1 and dist B + 1."""
    return _mih_knn(index.buckets, index.codes, queries, b=index.b, k=k)


def _mih_knn(buckets: torch.Tensor, codes: torch.Tensor, queries: torch.Tensor, b: int, k: int):
    B_bits = codes.shape[1] * 32
    Q = queries.shape[0]
    subs_q = _substrings(queries, b).long()  # (Q, m)
    m = subs_q.shape[1]
    cand = buckets[torch.arange(m, device=queries.device), subs_q].reshape(Q, -1)  # (Q, m cap)
    dbc = codes[torch.clamp(cand, min=0).long()]  # (Q, C, n_words)
    ham = _popcount32(dbc ^ queries[:, None]).sum(-1).to(torch.int32)
    ham = torch.where(cand >= 0, ham, B_bits + 1)
    # an id found in several tables counts once: the first of its copies in the stable order by id
    sc, order = torch.sort(cand, dim=1, stable=True)
    dup = torch.cat([torch.zeros((Q, 1), dtype=torch.bool, device=cand.device), sc[:, 1:] == sc[:, :-1]], 1)
    ham = ham.scatter(1, order, torch.where(dup, B_bits + 1, torch.gather(ham, 1, order)))
    # the k nearest, ties by the lower candidate position (`lax.top_k` of -ham)
    top_i = torch.sort(ham, dim=1, stable=True).indices[:, :k]
    top_d = torch.gather(ham, 1, top_i)
    return torch.where(top_d < B_bits + 1, torch.gather(cand, 1, top_i), -1), top_d


def mih_radius_match(index: MIHIndex, queries: torch.Tensor, radius: int, max_results: int = 16):
    """Radius match (BinaryDescriptorMatcher::radiusMatch): every probed
    candidate within Hamming `radius`; exact for radius < m tables
    (pigeonhole), as in the reference."""
    idx, dist = mih_knn_match(index, queries, k=max_results)
    ok = dist <= radius
    return torch.where(ok, idx, -1), torch.where(ok, dist, index.codes.shape[1] * 32 + 1)
