"""Image-quality metrics (the port of the image half of
opencv_contrib_tpu/utils/metrics.py, :71-117: QualityMSE / PSNR / SSIM /
GMSD of the quality module, quality/README.md:9-22). Maps go through the
grid_transform kernel and means through grid_reduce.

`mse` and `psnr` return Python floats, as the JAX versions do, so each call
waits for the device once."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.cuda import reduce, transform


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def _mean(m: transform.Map, *arrays: torch.Tensor) -> torch.Tensor:
    return reduce.grid_reduce(m, *arrays, div=float(arrays[0].numel()))


def mse(a, b) -> float:
    a, b = transform.as_2d(_f32(a)), transform.as_2d(_f32(b))
    return float(_mean(transform.sqdiff(), a, b))


def psnr(a, b, max_val: float = 1.0) -> float:
    """QualityPSNR parity."""
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val * max_val / m))


def ssim(a, b, max_val: float = 1.0, sigma: float = 1.5) -> torch.Tensor:
    """QualitySSIM parity (Gaussian-windowed, standard constants) of two
    (H, W) images: the mean of the SSIM map."""
    a, b = _f32(a), _f32(b)
    mu_a = filters.gaussian_blur(a, sigma)
    mu_b = filters.gaussian_blur(b, sigma)
    saa = filters.gaussian_blur(a * a, sigma)
    sbb = filters.gaussian_blur(b * b, sigma)
    sab = filters.gaussian_blur(a * b, sigma)
    s = transform.grid_transform(transform.ssim((0.01 * max_val) ** 2, (0.03 * max_val) ** 2),
                                 mu_a, mu_b, saa, sbb, sab)
    return _mean(transform.ident(), s)


def _half(a: torch.Tensor) -> torch.Tensor:
    """The 2x2 mean of an image with even sides (the GMSD paper's
    downsampling); an image with an odd side is kept as it is."""
    if a.shape[0] % 2 or a.shape[1] % 2:
        return a
    return (a[::2, ::2] + a[1::2, ::2] + a[::2, 1::2] + a[1::2, 1::2]) / 4.0


def gmsd(a, b, c: float = 0.0026) -> torch.Tensor:
    """QualityGMSD parity: the deviation (ddof 0) of the gradient-magnitude
    similarity of Prewitt gradients on the 2x2-downsampled images."""
    a2, b2 = _half(_f32(a)), _half(_f32(b))
    k = torch.zeros((3, 3), device=a2.device)  # [[1, 0, -1]] * 3 / 3, made on the device without a copy
    k[:, 0], k[:, 2] = 1.0, -1.0
    k = k / 3.0
    g = [filters.conv2d(x, kk) for x in (a2, b2) for kk in (k, k.T)]
    gms = transform.grid_transform(transform.gms(c), *g)
    mean = _mean(transform.ident(), gms)
    return torch.sqrt(_mean(transform.sqdev(mean), gms))
