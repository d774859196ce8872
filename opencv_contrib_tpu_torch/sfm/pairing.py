"""Image-pair pruning for large-scale matching — the port of
opencv_contrib_tpu/sfm/pairing.py.

A compact global descriptor per image (a bag of words over a random,
training-free codebook), one all-pairs similarity product, and top-k pair
selection in place of the reference's all-pairs match sweep.
"""

from __future__ import annotations

import numpy as np
import torch


def make_codebook(dim: int, n_words: int = 128, seed: int = 0, device="cpu") -> torch.Tensor:
    """Random unit codebook (n_words, dim)."""
    rng = np.random.default_rng(seed)
    C = rng.normal(size=(n_words, dim)).astype(np.float32)
    return torch.from_numpy(C / np.linalg.norm(C, axis=1, keepdims=True)).to(device)


def bow_descriptor(descs: torch.Tensor, valid: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(..., K, D) local descriptors and their validity (..., K) -> (..., n_words)
    tf-normalized bag of words."""
    word = torch.argmax(descs @ codebook.T, dim=-1)  # (..., K)
    h = torch.zeros(descs.shape[:-2] + (codebook.shape[0],), dtype=codebook.dtype, device=descs.device)
    h = h.scatter_add(-1, word, valid.to(h.dtype))
    return h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True), min=1e-9)


def pair_similarity(bows: torch.Tensor) -> torch.Tensor:
    """(N, W) image bags of words -> (N, N) cosine similarity, zero diagonal."""
    s = bows @ bows.T
    return s - torch.diag_embed(torch.diagonal(s))


def select_pairs(descs, valids, codebook=None, k: int = 8, device=None):
    """Top-k candidate pairs per image by bag-of-words similarity.

    descs (N, K, D), valids (N, K): tensors, or arrays that go to `device`
    (by default the device of `descs`, the CPU for arrays). Returns a sorted,
    deduplicated list of (i, j) pairs, the match schedule that replaces the
    all-pairs sweep."""
    if device is None:
        device = descs.device if isinstance(descs, torch.Tensor) else "cpu"
    descs = torch.as_tensor(descs, dtype=torch.float32, device=device)
    valids = torch.as_tensor(valids, device=device)
    if codebook is None:
        codebook = make_codebook(descs.shape[-1], device=device)
    sim = pair_similarity(bow_descriptor(descs, valids, codebook)).cpu().numpy()
    N = sim.shape[0]
    k = min(k, N - 1)
    pairs = set()
    for i in range(N):
        for j in np.argsort(-sim[i])[:k]:
            if i != int(j):
                pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)
