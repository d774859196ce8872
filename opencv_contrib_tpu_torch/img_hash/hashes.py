"""Perceptual hash implementations (the port of
opencv_contrib_tpu/img_hash/hashes.py; anchors in the package docstring).

Three settled differences from the twin:
- `jnp.median` of an even count averages the two middle values, where
  `torch.median` returns the lower one: `_median` takes the twin's rule.
- torch has no `cbrt`: the colour moments' cube root is sign(x) |x|^(1/3),
  within an ulp or two of `jnp.cbrt`.
- The radial variance's scatter-adds are `index_put_(accumulate=True)`,
  whose sums the card gives bit for bit on every call (`index_add_`'s
  atomics change their order run to run).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opencv_contrib_tpu_torch.core import color
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import resize
from opencv_contrib_tpu_torch.utils.device import as_float


def _to_gray(img):
    img = as_float(img)
    if img.ndim == 3:
        return color.rgb_to_gray(img)
    return img


def _median(x: torch.Tensor) -> torch.Tensor:
    """`jnp.median` of all of x: the mean of the two middle sorted values
    ((lo + hi) * 0.5) for an even count, the middle one for an odd."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def average_hash(img) -> torch.Tensor:
    """AverageHash: 8x8 mean-threshold bits -> (64,) bool."""
    g = _to_gray(img)
    small = resize(g, (8, 8), method="area") if g.shape[0] % 8 == 0 else resize(g, (8, 8))
    return (small > small.mean()).reshape(-1)


def block_mean_hash(img, blocks: int = 16) -> torch.Tensor:
    """BlockMeanHash mode 0: blocks x blocks block means vs their median."""
    g = resize(_to_gray(img), (blocks * 4, blocks * 4))
    means = g.reshape(blocks, 4, blocks, 4).mean(dim=(1, 3))
    return (means > _median(means)).reshape(-1)


def _dct_matrix(n: int, device=None) -> torch.Tensor:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    M = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    M[0] /= np.sqrt(2.0)
    return torch.as_tensor(M.astype(np.float32), device=device)


def phash(img) -> torch.Tensor:
    """PHash: 32x32 DCT, top-left 8x8 (minus DC) vs median -> 64 bits."""
    g = resize(_to_gray(img), (32, 32))
    M = _dct_matrix(32, g.device)
    d = M @ g @ M.T
    vals = d[:8, :8].reshape(-1)
    med = _median(vals[1:])
    return vals > med


def color_moment_hash(img) -> torch.Tensor:
    """ColorMomentHash: the first three moments of each channel in RGB, HSV
    and YCrCb: 27 floats."""
    img = as_float(img)
    assert img.ndim == 3
    feats = []
    for space in (img, color.rgb_to_hsv(torch.clamp(img, 0, 1)), color.rgb_to_ycrcb(img)):
        for c in range(3):
            ch = space[..., c]
            mu = ch.mean()
            sd = torch.sqrt(torch.mean((ch - mu) ** 2))
            sk = _cbrt(torch.mean((ch - mu) ** 3))
            feats += [mu, sd, sk]
    return torch.stack(feats)


@functools.lru_cache(maxsize=None)
def _radial_bins(n_angles: int) -> np.ndarray:
    """The angle bin of each pixel of the 64x64 image, (4096,) int64: the
    twin's float32 formula on the host, with the angle rounded from float64.
    The diagonal pixels' angle is pi / 4 exactly, a bin edge: `jnp.arctan2`
    rounds it to float32(pi / 4), one ulp above float32 `torch.atan2`'s and
    `np.arctan2`'s, which would move 32 pixels to the bin below."""
    y = np.arange(64, dtype=np.float32)[:, None] - np.float32(31.5)
    x = np.arange(64, dtype=np.float32)[None, :] - np.float32(31.5)
    pi = np.float32(np.pi)
    ang = np.mod(np.arctan2(*np.broadcast_arrays(y.astype(np.float64), x)).astype(np.float32), pi)
    return np.clip((ang / pi * np.float32(n_angles)).astype(np.int32), 0, n_angles - 1).reshape(-1).astype(np.int64)


def radial_variance_hash(img, n_angles: int = 40) -> torch.Tensor:
    """RadialVarianceHash: the variance of the pixels along each of
    n_angles radial lines of the 64x64 image, over the largest."""
    g = resize(_to_gray(img), (64, 64))
    dev = g.device
    flat_b = (torch.tensor(_radial_bins(n_angles), device=dev),)  # a copy: the cached table stays as it is
    flat_g = g.reshape(-1)

    def add(v):
        return torch.zeros(n_angles, device=dev).index_put_(flat_b, v, accumulate=True)

    s1 = add(flat_g)
    s2 = add(flat_g * flat_g)
    n = add(torch.ones_like(flat_g))
    var = s2 / torch.clamp(n, min=1) - (s1 / torch.clamp(n, min=1)) ** 2
    return var / torch.clamp(var.max(), min=1e-9)


def marr_hildreth_hash(img) -> torch.Tensor:
    """MarrHildrethHash: the signs of the LoG response's 4x4 block means
    against each block's 8 neighbours -> 14 x 14 x 8 bits."""
    g = resize(_to_gray(img), (64, 64))
    log = filters.laplacian(filters.gaussian_blur(g, 2.0))
    blocks = log.reshape(16, 4, 16, 4).mean(dim=(1, 3))
    c = blocks[1:-1, 1:-1]
    bits = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            bits.append((blocks[1 + dy:15 + dy, 1 + dx:15 + dx] > c).reshape(-1))
    return torch.cat(bits)


def hamming_compare(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Bit hash distance (ImgHashBase::compare for binary hashes)."""
    return torch.sum(h1 != h2)
