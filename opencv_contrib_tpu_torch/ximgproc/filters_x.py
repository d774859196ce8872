"""Edge-aware filter family (the port of
opencv_contrib_tpu/ximgproc/filters_x.py): anisotropic diffusion, the
rolling guidance filter, the domain-transform recursive filter, Niblack's
threshold and the ridge filter.

`dt_filter`'s recursion is a `lax.scan` along the scanline in the JAX
version. Here it steps over the scan axis with every line of the image in
one (lines,) vector a step: two launches a step (a difference and a fused
multiply-add written into the output row), no host sync. At 480 x 640 with
n_iters = 3 that is 3 x 2 x 2 x (640 + 480) = 13,440 launches, which set
its time, not the arithmetic."""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters


def anisotropic_diffusion(img: torch.Tensor, alpha: float = 0.15, K: float = 0.1, n_iters: int = 20) -> torch.Tensor:
    """Perona-Malik diffusion (parity: cv::ximgproc::anisotropicDiffusion);
    the four neighbour differences wrap at the borders (`jnp.roll`)."""
    x = img.to(torch.float32)

    def g(d):
        return torch.exp(-((d / K) ** 2))

    for _ in range(n_iters):
        n = torch.roll(x, -1, 0) - x
        s = torch.roll(x, 1, 0) - x
        e = torch.roll(x, -1, 1) - x
        w = torch.roll(x, 1, 1) - x
        x = x + alpha * (g(n) * n + g(s) * s + g(e) * e + g(w) * w)
    return x


def rolling_guidance_filter(img: torch.Tensor, sigma_s: float = 3.0, sigma_r: float = 0.1,
                            n_iters: int = 4) -> torch.Tensor:
    """Rolling guidance filter (parity: cv::ximgproc::rollingGuidanceFilter):
    iterated joint-bilateral with the evolving guide."""
    img = img.to(torch.float32)
    guide = filters.gaussian_blur(img, sigma_s)
    for _ in range(n_iters):
        guide = _joint_bilateral(guide, img, sigma_s, sigma_r)
    return guide


def _joint_bilateral(guide, src, sigma_s, sigma_r, radius: int = 4):
    num = torch.zeros_like(src)
    den = torch.zeros_like(src)
    inv2ss = 1.0 / (2 * sigma_s * sigma_s)
    inv2sr = 1.0 / (2 * sigma_r * sigma_r)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            gs = math.exp(-(dy * dy + dx * dx) * inv2ss)
            g_shift = torch.roll(guide, (dy, dx), (0, 1))
            s_shift = torch.roll(src, (dy, dx), (0, 1))
            w = gs * torch.exp(-((g_shift - guide) ** 2) * inv2sr)
            num = num + w * s_shift
            den = den + w
    return num / torch.clamp(den, min=1e-9)


def _recursive_scan(xT: torch.Tensor, wT: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The first-order recursion y_i = x_i + w_i (y_{i-1} - x_i) along axis 0
    of (L, N), every column at once, starting from y = x at the first step
    (the JAX version's scan from xT[0]); `reverse` runs it from the end."""
    L = xT.shape[0]
    out = torch.empty_like(xT)
    order = range(L - 1, -1, -1) if reverse else range(L)
    it = iter(order)
    prev = next(it)
    out[prev].copy_(xT[prev])
    for i in it:
        torch.addcmul(xT[i], wT[i], out[prev] - xT[i], out=out[i])
        prev = i
    return out


def _rf_pass(x: torch.Tensor, dct: torch.Tensor, a: float) -> torch.Tensor:
    """One horizontal RF pass over (H, W): forward then backward along the
    rows with feedback a ** dct."""
    wT = (a ** dct).T.contiguous()
    out = _recursive_scan(x.T.contiguous(), wT)
    return _recursive_scan(out, wT, reverse=True).T


def _sigma_h(sigma_s: float, i: int, n_iters: int) -> np.float32:
    """The i-th pass's sigma in float32, in the JAX version's order."""
    f = np.float32
    return f(sigma_s) * np.sqrt(f(3.0)) * f(2.0 ** (n_iters - i - 1)) / np.sqrt(f(4.0 ** n_iters - 1.0))


def dt_filter(guide: torch.Tensor, src: torch.Tensor, sigma_s: float = 8.0, sigma_r: float = 0.2,
              n_iters: int = 3) -> torch.Tensor:
    """Domain-transform recursive filter (parity: cv::ximgproc::dtFilter,
    DTF_RF mode): the 1D recursive smoothing alternates rows/columns in the
    transformed domain."""
    gy, gx = filters.gradients(guide.to(torch.float32))
    out = src.to(torch.float32)
    dctx = 1.0 + sigma_s / sigma_r * torch.abs(gx)
    dcty = (1.0 + sigma_s / sigma_r * torch.abs(gy)).T
    for i in range(n_iters):
        a = float(np.exp(-np.sqrt(np.float32(2.0)) / _sigma_h(sigma_s, i, n_iters)))
        out = _rf_pass(out, dctx, a)
        out = _rf_pass(out.T, dcty, a).T
    return out


def niblack_threshold(img: torch.Tensor, block_radius: int = 7, k: float = -0.2) -> torch.Tensor:
    """Niblack local threshold (parity: cv::ximgproc::niBlackThreshold):
    T = mean + k * stddev over the window; returns binary mask."""
    img = img.to(torch.float32)
    mu = filters.box_filter(img, block_radius)
    var = filters.box_filter(img * img, block_radius) - mu * mu
    T = mu + k * torch.sqrt(torch.clamp(var, min=0.0))
    return img > T


def ridge_filter(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Ridge detection via Hessian eigenvalues (parity:
    cv::ximgproc::RidgeDetectionFilter): the eigenvalue of larger magnitude."""
    g = filters.gaussian_blur(img.to(torch.float32), sigma)
    gy, gx = filters.gradients(g)
    gyy, gyx = filters.gradients(gy)
    gxy, gxx = filters.gradients(gx)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    l1 = tr / 2.0 + disc
    l2 = tr / 2.0 - disc
    return torch.where(torch.abs(l1) > torch.abs(l2), l1, l2)
