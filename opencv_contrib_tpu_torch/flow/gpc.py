"""GPC: Global Patch Collider sparse matching — the port of
opencv_contrib_tpu/flow/gpc.py (optflow/src/sparse_matching_gpc.cpp
GPCForest: decision trees over patch descriptors hash every pixel of both
images to leaves; pixels that collide in the same leaf of every tree become
correspondences, sparse_matching_gpc.hpp:295 findCorrespondences).

Every pixel's descriptor comes from a bank of 3x3 separable DCT filters;
each tree is a sequence of hyperplane splits evaluated for all pixels at
once, giving an integer code a pixel a tree; the trees' codes are combined
into one int32 hash (wrapping at 2^32 as the JAX package's int32 does) and
the collision join runs on the host, as in the JAX package.

The random forest is drawn from an explicit `torch.Generator` (the JAX
package draws with `jax.random`; the two draws differ, so the tests carry a
JAX forest across as numpy)."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters

DESC_DIM = 9


def patch_descriptors(img) -> torch.Tensor:
    """Per-pixel descriptors: responses to the 3x3 separable DCT filters
    (the reference's patch descriptor is a DCT of the patch). (H, W, 9)."""
    img = img.to(torch.float32)
    b = [torch.tensor([1.0, 1.0, 1.0]) / torch.sqrt(torch.tensor(3.0)),
         torch.tensor([1.0, 0.0, -1.0]) / torch.sqrt(torch.tensor(2.0)),
         torch.tensor([1.0, -2.0, 1.0]) / torch.sqrt(torch.tensor(6.0))]  # host taps, read as scalars
    return torch.stack([filters.sep_filter2d(img, ky, kx) for ky in b for kx in b], dim=-1)


def make_forest(generator: torch.Generator, n_trees: int = 4, depth: int = 8, device="cpu") -> torch.Tensor:
    """Random hyperplane forest (n_trees, depth, DESC_DIM + 1) [w | b],
    unit normals drawn from `generator` (on its device), biases 0."""
    w = torch.randn((n_trees, depth, DESC_DIM), generator=generator, device=generator.device)
    w = w / torch.linalg.norm(w, dim=-1, keepdim=True)
    return torch.cat([w, torch.zeros((n_trees, depth, 1), device=w.device)], dim=-1).to(device)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] (broadcast), in the order of XLA's CPU
    dot for these 9 terms: two fused multiply-add chains (`addcmul`) over the
    even and the odd k below the last pair, their sum, then the last odd
    term's product. On the CPU the responses then equal the JAX package's
    bit for bit, so a pixel whose descriptor set a split's median
    (resp - bias = 0) hashes as it does there. Training and hashing share
    this order."""
    K = a.shape[-1]
    even = a[..., 0] * b[..., 0]
    odd = a[..., 1] * b[..., 1]
    for k in range(2, K - K % 2, 2):
        even = torch.addcmul(even, a[..., k], b[..., k])
        odd = torch.addcmul(odd, a[..., k + 1], b[..., k + 1])
    acc = even + odd
    return acc + a[..., K - 1] * b[..., K - 1] if K % 2 else acc


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis, keepdim, as jnp.median takes it: the
    middle two sorted values' (sum) * 0.5."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    lo, hi = (n - 1) // 2, n // 2
    return (s[..., lo:lo + 1] + s[..., hi:hi + 1]) * 0.5


def train_forest(forest: torch.Tensor, descs: torch.Tensor) -> torch.Tensor:
    """Set each split's bias to the median response over training
    descriptors descs (N, DESC_DIM) (balances the tree, GPCTree::trainNode's
    role)."""
    resp = _dot(forest[..., None, :DESC_DIM], descs[None, None])  # (T, D, N)
    return torch.cat([forest[..., :DESC_DIM], _median(resp)], dim=-1)


def leaf_codes(img, forest: torch.Tensor) -> torch.Tensor:
    """Hash every pixel: bit d of tree t is the sign of hyperplane (t, d).
    Returns (H, W) int32: the trees' codes combined with int32 wrap-around
    (tree t's code times (2^depth)^t, summed modulo 2^32), as the JAX
    package's int32 arithmetic gives."""
    d = patch_descriptors(img)
    resp = _dot(d[:, :, None, None], forest[..., :DESC_DIM]) - forest[..., DESC_DIM]  # (H, W, T, D)
    depth, T = forest.shape[1], forest.shape[0]
    pow2 = 2 ** torch.arange(depth, device=d.device)
    tree_code = ((resp > 0).long() * pow2).sum(-1)  # (H, W, T), < 2^depth
    mult = (2 ** depth) ** torch.arange(T, device=d.device)
    mult = torch.remainder(mult, 2 ** 32)  # each factor as int32 wraps it
    code = torch.remainder((tree_code * mult).sum(-1), 2 ** 32)  # int64 products: exact before the wrap
    return torch.where(code >= 2 ** 31, code - 2 ** 32, code).to(torch.int32)


def find_correspondences(I0, I1, forest, max_matches: int = 2048):
    """Pixels with identical forest codes in both images and unique within
    each image become matches (GPCForest::findCorrespondences). Returns
    (pts0 (M, 2), pts1 (M, 2)) numpy float32 (y, x)."""
    def codes(img):
        img = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.array(img, np.float32))
        return leaf_codes(img.to(forest.device), forest).cpu().numpy().reshape(-1)

    c0, c1 = codes(I0), codes(I1)
    H, W = I0.shape

    def unique_map(c):
        order = np.argsort(c, kind="stable")
        cs = c[order]
        first = np.r_[True, cs[1:] != cs[:-1]]
        last = np.r_[cs[1:] != cs[:-1], True]
        uniq = first & last
        return cs[uniq], order[uniq]

    k0, i0 = unique_map(c0)
    k1, i1 = unique_map(c1)
    _, a, b = np.intersect1d(k0, k1, return_indices=True)
    p0 = np.stack(np.unravel_index(i0[a], (H, W)), 1)
    p1 = np.stack(np.unravel_index(i1[b], (H, W)), 1)
    if p0.shape[0] > max_matches:
        p0, p1 = p0[:max_matches], p1[:max_matches]
    return p0.astype(np.float32), p1.astype(np.float32)
