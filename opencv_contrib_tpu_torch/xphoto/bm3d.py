"""BM3D image denoising, two steps: hard threshold, then Wiener (the port of
opencv_contrib_tpu/xphoto/bm3d.py; xphoto/src/bm3d_image_denoising.cpp:94
and its step-1 / step-2 invokers).

Every reference patch on the stride grid is matched against the patches of
its search window in the 2D-DCT domain, its `group` nearest form a group,
the group is transformed across its members (1D Haar), shrunk (a hard
threshold, or Wiener weights from the basic estimate), transformed back and
aggregated with one weight a group.

On the device, at any size (1080 x 1920 holds 269 x 479 references with
289 candidates of 64 coefficients each, 9.5 GB if materialised):
- the distances are taken one window offset at a time, each a pass over
  the grid's DCT coefficients against a shifted (edge-clamped) copy, into a
  (Ry, Rx, 289) table; a stable sort of each row picks the group, so ties
  (the clamped duplicates at the borders) go to the lower candidate index,
  as `lax.top_k` breaks them;
- the aggregation is a gather, not a scatter: the group members are sorted
  by the grid patch they land on (stable, so each patch's contributions
  keep their (reference, member) order), and a loop over the rank within a
  patch adds the k-th contribution of every patch at once; the patches are
  then overlap-added into the image by `F.fold`, whose sum for each pixel
  runs in a fixed order. No float atomics: a rerun gives the same bits, and
  no slot is walked serially. The longest run of contributions to one patch
  is read back to the host once a step (one sync).
The DCT and Haar transforms are matrix products.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _dct_cpu(n: int) -> torch.Tensor:
    """The orthonormal DCT-II matrix, computed in float32 in the JAX
    package's order of operations."""
    k = torch.arange(n)
    M = torch.cos(math.pi * (2 * k[None, :] + 1).to(torch.float32) * k[:, None].to(torch.float32) / (2 * n))
    M = M * torch.sqrt(torch.tensor(2.0 / n, dtype=torch.float32))
    M[0] = M[0] * (1.0 / torch.sqrt(torch.tensor(2.0, dtype=torch.float32)))
    return M


@functools.lru_cache(maxsize=None)
def _haar_np(n: int) -> np.ndarray:
    """Orthonormal Haar transform for power-of-two n."""
    M = np.array([[1.0]])
    while M.shape[0] < n:
        m = M.shape[0]
        top = np.kron(M, [1.0, 1.0])
        bot = np.kron(np.eye(m), [1.0, -1.0])
        M = np.vstack([top, bot]) / np.sqrt(2.0)
    return M.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _transforms(patch: int, group: int, device: str):
    """(the DCT matrix, the Haar matrix) on `device`, copied there once (a
    copy from the host waits for the stream)."""
    return _dct_cpu(patch).to(device), torch.from_numpy(_haar_np(group)).to(device)


def _patch_dct(img: torch.Tensor, D: torch.Tensor, P: int, stride: int) -> torch.Tensor:
    """The 2D DCT of every patch on the stride grid: (Ry, Rx, P, P)."""
    patches = img.unfold(0, P, stride).unfold(1, P, stride)
    return D @ patches @ D.T


def _match(flat: torch.Tensor, search: int, group: int):
    """(iy, ix) of each reference's group, (Ry, Rx, group) each: the
    `group` candidates of its (2 search + 1)^2 edge-clamped window nearest
    in squared L2, nearest first, ties to the lower candidate index."""
    Ry, Rx, _ = flat.shape
    dev = flat.device
    offs = torch.arange(-search, search + 1, device=dev)
    S = offs.numel()
    cy = torch.clamp(torch.arange(Ry, device=dev)[:, None] + offs, 0, Ry - 1)  # (Ry, S)
    cx = torch.clamp(torch.arange(Rx, device=dev)[:, None] + offs, 0, Rx - 1)  # (Rx, S)
    d = torch.empty(Ry, Rx, S * S, dtype=flat.dtype, device=dev)
    for a in range(S):
        rows = flat.index_select(0, cy[:, a])
        for b in range(S):
            d[..., a * S + b] = ((rows.index_select(1, cx[:, b]) - flat) ** 2).sum(-1)
    sel = torch.sort(d, dim=-1, stable=True).indices[..., :group]
    del d
    iy = torch.gather(cy[:, None, :].expand(Ry, Rx, S), 2, sel // S)
    ix = torch.gather(cx[None, :, :].expand(Ry, Rx, S), 2, sel % S)
    return iy, ix


def _aggregate(spat: torch.Tensor, wgt: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, shape, P: int,
               stride: int):
    """(numerator, denominator) images of the weighted group patches:
    spat (Ry, Rx, G, P, P) lands on the grid patches (iy, ix), each group
    weighted by wgt (Ry, Rx)."""
    Ry, Rx, G = iy.shape
    R, N = Ry * Rx, Ry * Rx * G
    target = (iy * Rx + ix).reshape(N)
    order = torch.sort(target, stable=True).indices
    vals = (spat * wgt[..., None, None, None]).reshape(N, P * P)[order]
    wts = wgt[..., None].expand(Ry, Rx, G).reshape(N)[order]
    counts = torch.zeros(R, dtype=torch.int64, device=target.device)
    counts.scatter_add_(0, target, torch.ones_like(target))  # integer atomics: exact (bincount reads its max back)
    starts = torch.cumsum(counts, 0) - counts
    acc = torch.zeros(R, P * P, dtype=spat.dtype, device=spat.device)
    accw = torch.zeros(R, dtype=spat.dtype, device=spat.device)
    for k in range(int(counts.max())):  # the longest run: one host read a call
        has = counts > k
        at = torch.clamp(starts + k, max=N - 1)
        acc += torch.where(has[:, None], vals[at], 0.0)
        accw += torch.where(has, wts[at], 0.0)
    fold = functools.partial(F.fold, output_size=tuple(shape), kernel_size=P, stride=stride)
    num = fold(acc.T[None])[0, 0]
    den = fold(accw[None, None, :].expand(1, P * P, R).contiguous())[0, 0]
    return num, den


def _f32(x: float) -> float:
    """x rounded to float32, as the JAX package's traced scalars hold it."""
    return float(np.float32(x))


def bm3d_denoise(img, sigma: float = 0.1, patch: int = 8, stride: int = 4, search: int = 8, group: int = 8):
    """BM3D step 1 on a grayscale image in [0, 1]. `search` is the window
    half-size in stride units; `group` the (power-of-two) patches a group."""
    img = img.to(torch.float32)
    P = patch
    D, Hm = _transforms(P, group, str(img.device))
    tp = _patch_dct(img, D, P, stride)
    Ry, Rx = tp.shape[:2]
    iy, ix = _match(tp.reshape(Ry, Rx, P * P), search, group)
    grp = tp[iy, ix].reshape(Ry, Rx, group, P * P)
    t3 = Hm @ grp
    lam = _f32(np.float32(2.7) * np.float32(sigma))
    kept = torch.abs(t3) > lam
    t3 = torch.where(kept, t3, 0.0)
    n_kept = kept.sum((-2, -1)).to(torch.float32)
    spat = D.T @ (Hm.T @ t3).reshape(Ry, Rx, group, P, P) @ D
    # weight 1 / (1 + n_kept) a group (the reference's 1 / (sigma^2 N_kept); the constant cancels)
    num, den = _aggregate(spat, 1.0 / (1.0 + n_kept), iy, ix, img.shape, P, stride)
    return torch.where(den > 0, num / torch.clamp(den, min=1e-8), img)


def bm3d_denoise_step2(img, basic, sigma: float = 0.1, patch: int = 8, stride: int = 4, search: int = 8,
                       group: int = 8):
    """BM3D step 2, Wiener collaborative filtering: block-match on the
    basic estimate, transform the basic and the noisy groups, shrink the
    noisy spectra by w = |T_basic|^2 / (|T_basic|^2 + sigma^2) and aggregate
    with weight 1 / sum(w^2)."""
    img, basic = img.to(torch.float32), basic.to(torch.float32)
    P = patch
    D, Hm = _transforms(P, group, str(img.device))
    tp_basic = _patch_dct(basic, D, P, stride)
    tp_noisy = _patch_dct(img, D, P, stride)
    Ry, Rx = tp_basic.shape[:2]
    iy, ix = _match(tp_basic.reshape(Ry, Rx, P * P), search, group)
    t3_basic = Hm @ tp_basic[iy, ix].reshape(Ry, Rx, group, P * P)
    t3_noisy = Hm @ tp_noisy[iy, ix].reshape(Ry, Rx, group, P * P)
    e = t3_basic ** 2
    wien = e / (e + _f32(np.float32(sigma) * np.float32(sigma)))
    t3 = wien * t3_noisy
    w_energy = (wien ** 2).sum((-2, -1))
    spat = D.T @ (Hm.T @ t3).reshape(Ry, Rx, group, P, P) @ D
    num, den = _aggregate(spat, 1.0 / (1e-6 + w_energy), iy, ix, img.shape, P, stride)
    return torch.where(den > 0, num / torch.clamp(den, min=1e-8), basic)


def bm3d(img, sigma: float = 0.1, patch: int = 8, stride: int = 4, search: int = 8, group: int = 8):
    """Full two-step BM3D (BM3D_STEPALL, bm3d_image_denoising.cpp:94):
    hard-threshold basic estimate, then Wiener refinement."""
    basic = bm3d_denoise(img, sigma, patch, stride, search, group)
    return bm3d_denoise_step2(img, basic, sigma, patch, stride, search, group)
