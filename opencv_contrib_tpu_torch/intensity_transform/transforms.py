"""Global intensity transforms on float images in [0, 1] (the port of
opencv_contrib_tpu/intensity_transform/transforms.py). The gamma runs as one
streamed_transform over the whole array, and the global min and max come
from grid_reduce."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.cuda import reduce, transform


def gamma_correction(img: torch.Tensor, gamma: float) -> torch.Tensor:
    """clip(img, 0, 1) ** gamma: one streamed_transform launch over img
    viewed as (rows, W * C), however many frames it holds."""
    x = img.to(torch.float32)
    return transform.streamed_transform(transform.gamma(gamma), transform.as_2d(x)).reshape(x.shape)


def _extreme(img: torch.Tensor, kind: str) -> torch.Tensor:
    return reduce.grid_reduce(transform.ident(), transform.as_2d(img.to(torch.float32)), kind=kind)


def log_transform(img: torch.Tensor) -> torch.Tensor:
    """log(1 + img) scaled to [0, 1] (logTransform semantics)."""
    c = 1.0 / torch.log1p(torch.clamp(_extreme(img, "max"), min=1e-9))
    return c * torch.log1p(torch.clamp(img.to(torch.float32), min=0.0))


def autoscaling(img: torch.Tensor) -> torch.Tensor:
    mn, mx = _extreme(img, "min"), _extreme(img, "max")
    return (img - mn) / torch.clamp(mx - mn, min=1e-9)


def contrast_stretching(img: torch.Tensor, r1: float, s1: float, r2: float, s2: float) -> torch.Tensor:
    """Piecewise-linear contrast stretch through (r1, s1), (r2, s2). The
    first slope is the float32 quotient, as the JAX version's scalars give
    it."""
    k1 = float(np.float32(s1) / np.maximum(np.float32(r1), np.float32(1e-9)))
    a = torch.where(img < r1, img * k1,
                    torch.where(img < r2, s1 + (img - r1) * (s2 - s1) / max(r2 - r1, 1e-9),
                                s2 + (img - r2) * (1.0 - s2) / max(1.0 - r2, 1e-9)))
    return torch.clamp(a, 0.0, 1.0)


def bimef(img: torch.Tensor, mu: float = 0.5) -> torch.Tensor:
    """BIMEF-style low-light enhancement (simplified): illumination map from
    the smoothed max channel, camera-response exposure boost of dark
    regions, weighted fusion."""
    lum = img.amax(dim=-1) if img.ndim == 3 else img
    illum = torch.clamp(filters.guided_filter(lum, lum, radius=7, eps=1e-3), 1e-3, 1.0)
    k = (1.0 / illum) ** 0.8
    w = illum ** mu
    if img.ndim == 3:
        k, w = k[..., None], w[..., None]
    enhanced = torch.clamp(img * k, 0.0, 1.0)
    return torch.clamp(w * img + (1 - w) * enhanced, 0.0, 1.0)
