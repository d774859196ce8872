"""Fourier descriptors for contours (the port of
opencv_contrib_tpu/ximgproc/fourier.py; parity: cv::ximgproc::fourierDescriptor,
fourier_descriptors.hpp)."""

from __future__ import annotations

import torch


def fourier_descriptors(contour_yx: torch.Tensor, n_keep: int = 16, normalize: bool = True) -> torch.Tensor:
    """contour (N, 2) closed polygon -> complex descriptor magnitudes
    (n_keep,), optionally made translation/scale/rotation invariant."""
    c = contour_yx.to(torch.float32)
    z = torch.complex(c[:, 1], c[:, 0])
    F = torch.fft.fft(z)
    if normalize:
        F = torch.cat([torch.zeros_like(F[:1]), F[1:]])  # translation invariance
        mag1 = torch.abs(F[1])
        F = F / torch.clamp(mag1, min=1e-9)  # scale invariance
    desc = torch.abs(F)  # rotation/start-point invariance
    half = n_keep // 2
    return torch.cat([desc[1:1 + half], desc[-half:]])
