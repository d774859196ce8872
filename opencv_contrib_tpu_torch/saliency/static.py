"""Static saliency maps (the port of opencv_contrib_tpu/saliency/static.py).

`fine_grained` reads its box means from `ops.integral.integral`: on a CUDA
tensor one launch of the integral kernel a call. `spectral_residual`'s
FFTs are complex64 `torch.fft` calls; cuFFT and XLA's CPU FFT round
differently, so the maps agree to a few ulps of their scale, not in bits.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops import integral as integ
from opencv_contrib_tpu_torch.ops.image import resize
from opencv_contrib_tpu_torch.utils.device import as_float


def spectral_residual(img, out_size=(64, 64)) -> torch.Tensor:
    """StaticSaliencySpectralResidual (Hou-Zhang): saliency = |ifft(exp(
    (log|F| - avg log|F|) + i phase))|^2, smoothed; computed at 64x64, then
    resized to the image (the reference's recipe)."""
    img = as_float(img)
    H, W = img.shape
    small = resize(img, out_size)
    F = torch.fft.fft2(small.to(torch.complex64))
    logmag = torch.log(torch.abs(F) + 1e-9)
    phase = torch.angle(F)
    residual = logmag - filters.box_filter(logmag, 1)
    sal = torch.abs(torch.fft.ifft2(torch.exp(torch.complex(residual, phase)))) ** 2
    sal = filters.gaussian_blur(sal, 2.5)
    sal = resize(sal, (H, W))
    mn, mx = sal.min(), sal.max()
    return (sal - mn) / torch.clamp(mx - mn, min=1e-9)


def fine_grained(img, scales=(2, 4, 8)) -> torch.Tensor:
    """StaticSaliencyFineGrained: centre-surround differences of box means
    at several scales, on the summed-area table."""
    img = as_float(img)
    ii = integ.integral(img)
    H, W = img.shape
    y = torch.arange(H, dtype=torch.int64, device=img.device)[:, None].expand(H, W)
    x = torch.arange(W, dtype=torch.int64, device=img.device)[None, :].expand(H, W)
    sal = torch.zeros((H, W), device=img.device)
    for r in scales:
        center = integ.box_mean(ii, y - r // 2, x - r // 2, r, r)
        surround = integ.box_mean(ii, y - 2 * r, x - 2 * r, 4 * r, 4 * r)
        sal = sal + torch.abs(center - surround)
    mn, mx = sal.min(), sal.max()
    return (sal - mn) / torch.clamp(mx - mn, min=1e-9)
