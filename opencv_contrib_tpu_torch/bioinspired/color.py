"""Retina color multiplexing/demultiplexing and fast tone mapping (the port
of opencv_contrib_tpu/bioinspired/color.py).

Reference anchors (bioinspired):
- src/retinacolor.{hpp,cpp} — RetinaColor: color sampling (Bayer/diagonal),
  multiplexing to a single plane, adaptive demultiplexing with chrominance
  low-pass + luminance normalization
- src/retinafasttonemapping.cpp — RetinaFastToneMapping::applyFastToneMapping:
  two cascaded Naka-Rushton-style local adaptation stages (photoreceptor then
  ganglion), no temporal state

The mosaic masks are (H, W) planes; demultiplexing blurs the three masked
planes and the three masks in one separable blur of six maps (the twin's
vmap); tone mapping is two blur+divide stages.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.utils.device import to_device


def bayer_masks(shape, device="cpu"):
    """RGGB Bayer sampling masks (3, H, W) float32 (retinacolor.cpp color
    sampling mode RETINA_COLOR_BAYER)."""
    H, W = shape
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    r = ((ys % 2 == 0) & (xs % 2 == 0)).to(torch.float32)
    g = ((ys + xs) % 2 == 1).to(torch.float32)
    b = ((ys % 2 == 1) & (xs % 2 == 1)).to(torch.float32)
    return torch.stack([r, g, b])


def color_multiplex(rgb: torch.Tensor) -> torch.Tensor:
    """Multiplex an (H, W, 3) image into the single-plane retinal mosaic
    (RetinaColor::runColorMultiplexing)."""
    masks = bayer_masks(rgb.shape[:2], rgb.device)
    return (rgb.permute(2, 0, 1) * masks).sum(0)


def color_demultiplex(mosaic: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Demultiplex a mosaic plane back to (H, W, 3)
    (RetinaColor::runColorDemultiplexing): per-channel normalized low-pass
    of the sampled sites (adaptive interpolation), then a luminance
    re-normalization so demux(mux(x)) ~ x for smooth x."""
    masks = bayer_masks(mosaic.shape, mosaic.device)
    blurred = filters.gaussian_blur(torch.cat([mosaic[None] * masks, masks]).permute(1, 2, 0), sigma)  # (H, W, 6)
    return blurred[..., :3] / torch.clamp(blurred[..., 3:], min=1e-6)


def fast_tone_mapping(img: torch.Tensor, photoreceptor_sigma: float = 3.0, ganglion_sigma: float = 1.5,
                      mean_weight: float = 1.0) -> torch.Tensor:
    """Fast tone mapping (parity: cv::bioinspired::RetinaFastToneMapping,
    retinafasttonemapping.cpp): two cascaded local Naka-Rushton adaptations —
    V1 = L / (L + k*localmean_ph), V2 = V1 / (V1 + k*localmean_gang) — then
    rescaled to the input range. Works on gray (H, W) or color (H, W, 3)
    (color goes through the luminance, chrominance preserved)."""
    f = img.to(torch.float32)
    if f.ndim == 3:
        lum = f.mean(-1)
        chroma = f / torch.clamp(lum[..., None], min=1e-6)
    else:
        lum = f
        chroma = None

    def adapt(x, sigma):
        local = filters.gaussian_blur(x, sigma)
        comp = mean_weight * (local + x.mean())
        return (x * (1.0 + comp)) / (x + comp + 1e-9)

    v = adapt(lum, photoreceptor_sigma)
    v = adapt(v, ganglion_sigma)
    v = (v - v.min()) / torch.clamp(v.max() - v.min(), min=1e-9)
    v = v * (lum.max() - lum.min()) + lum.min()
    if chroma is not None:
        return torch.clamp(chroma * v[..., None], min=0.0)
    return v


def retina_run_color(retina, rgb):
    """Color parvo pathway: multiplex -> retina.run on the mosaic ->
    demultiplex the parvo output back to color (the reference's color
    pipeline shape: RetinaImpl::run with _useColorMode)."""
    mosaic = color_multiplex(to_device(rgb, retina.device))
    parvo, magno = retina.run(mosaic)
    return color_demultiplex(parvo), magno
