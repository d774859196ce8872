"""DCT-domain denoising (the port of opencv_contrib_tpu/xphoto/denoise.py;
xphoto dctDenoising, xphoto/src/dct_image_denoising.cpp): hard-threshold
the 2D DCT coefficients of 16 x 16 tiles and average a second, half-tile
shifted pass. All tiles are one batch of matrix products (M t M^T) on the
image's device.

The shifted pass is averaged into the whole image, the border the first
pass leaves (rows and columns past the last whole tile) included. The JAX
function averages it into the first pass's output alone, which is shorter
than the shifted region whenever H % tile or W % tile >= tile / 2 (1080 %
16 = 8), and then raises on the shapes; where it runs, the two agree."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _dct_np(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    M = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    M[0] /= np.sqrt(2.0)
    return M.astype(np.float32)


def _dct_matrix(n: int, device) -> torch.Tensor:
    return _dct_on(n, str(device))


@functools.lru_cache(maxsize=None)
def _dct_on(n: int, device: str) -> torch.Tensor:
    """The matrix on `device`, copied there once (a copy from the host waits for the stream)."""
    return torch.from_numpy(_dct_np(n)).to(device)


def _denoise_tiles(x: torch.Tensor, M: torch.Tensor, tile: int, sigma: float) -> torch.Tensor:
    Hc, Wc = x.shape
    t = x.reshape(Hc // tile, tile, Wc // tile, tile).permute(0, 2, 1, 3)
    coef = M @ t @ M.T
    keep = torch.abs(coef) > float(np.float32(3.0) * np.float32(sigma))  # the JAX package's float32 product
    keep[..., 0, 0].fill_(True)  # always keep DC (a fill: an item assignment copies from the host)
    back = M.T @ (coef * keep) @ M
    return back.permute(0, 2, 1, 3).reshape(Hc, Wc)


def dct_denoise(img: torch.Tensor, sigma: float = 0.05, tile: int = 16) -> torch.Tensor:
    """Grayscale (H, W) denoising; threshold = 3 sigma."""
    img = img.to(torch.float32)
    H, W = img.shape
    Hc, Wc = (H // tile) * tile, (W // tile) * tile
    M = _dct_matrix(tile, img.device)
    out = _denoise_tiles(img[:Hc, :Wc], M, tile, sigma)
    if Hc < H or Wc < W:
        out = torch.cat([torch.cat([out, img[:Hc, Wc:]], dim=1), img[Hc:]], dim=0)
    s = tile // 2
    Hs, Ws = ((H - s) // tile) * tile, ((W - s) // tile) * tile
    if Hs > 0 and Ws > 0:
        out2 = _denoise_tiles(img[s:s + Hs, s:s + Ws], M, tile, sigma)
        out = out.clone()
        out[s:s + Hs, s:s + Ws] = 0.5 * (out[s:s + Hs, s:s + Ws] + out2)
    return out
