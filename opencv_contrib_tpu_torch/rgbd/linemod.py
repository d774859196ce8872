"""LINEMOD template matching (the port of opencv_contrib_tpu/rgbd/linemod.py):
the quantised colour-gradient and surface-normal modalities, orientation
spreading, response maps, templates and their detection.

The quantised modalities are (H, W, 8) one-hot float maps; spreading is a
max over a T x T window; a template's score at a window is the mean response
of its features there. The normals come from `rgbd.frame`
(`depth_to_points`, `compute_normals`), as in the JAX version.
`extract_template` picks its features with numpy's `argsort` on the host,
the JAX version's call on the same array, so both pick the same pixels.
`Template.size` stays a Python tuple.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.rgbd.frame import compute_normals, depth_to_points
from opencv_contrib_tpu_torch.utils.device import constant

N_ORI = 8


def quantize_gradients(img: torch.Tensor, mag_thresh: float = 0.05):
    """The colour-gradient modality: the gradient orientation mod pi in 8
    bins where the magnitude passes mag_thresh. Returns ((H, W, 8) one-hot,
    magnitude (H, W))."""
    gy, gx = filters.gradients(img)
    mag = torch.sqrt(gy * gy + gx * gx)
    ang = (torch.atan2(gy, gx) + math.pi) % math.pi
    b = torch.clamp((ang / math.pi * N_ORI).to(torch.int64), 0, N_ORI - 1)
    return F.one_hot(b, N_ORI).to(img.dtype) * (mag > mag_thresh)[..., None], mag


def quantize_normals(depth: torch.Tensor, intr) -> torch.Tensor:
    """The surface-normal modality: normals binned by their (nx, ny)
    direction into 8 sectors, where the depth is valid and the surface is
    not seen flat on. Returns (H, W, 8) one-hot."""
    intr = torch.as_tensor(intr, dtype=torch.float32, device=depth.device)
    normals, _ = compute_normals(depth_to_points(depth, intr), depth > 0)
    ang = (torch.atan2(normals[..., 1], normals[..., 0]) + 2 * math.pi) % (2 * math.pi)
    b = torch.clamp((ang / (2 * math.pi) * N_ORI).to(torch.int64), 0, N_ORI - 1)
    strong = torch.abs(normals[..., 2]) < 0.98
    return F.one_hot(b, N_ORI).to(depth.dtype) * ((depth > 0) & strong)[..., None]


def spread(quantized: torch.Tensor, T: int = 4) -> torch.Tensor:
    """Orientation spreading: a bin is on at p when it is on anywhere in the
    T x T window below and right of p (zero past the border)."""
    H, W, _ = quantized.shape
    p = F.pad(quantized, (0, 0, 0, T - 1, 0, T - 1))
    out = torch.zeros_like(quantized)
    for dy in range(T):
        for dx in range(T):
            out = torch.maximum(out, p[dy:dy + H, dx:dx + W])
    return out


# the response of spread bin j to template bin i: |cos(pi (i - j) / 8)|
_COS = np.abs(np.cos(np.pi * (np.arange(N_ORI)[:, None] - np.arange(N_ORI)[None]) / N_ORI)).astype(np.float32)


def response_maps(spread_oh: torch.Tensor) -> torch.Tensor:
    """For each template orientation i, the best cosine response among the
    bins on at each pixel: (H, W, 8)."""
    cos = constant(_COS, spread_oh.device)[None, None]
    return torch.amax(torch.where(spread_oh[..., None, :] > 0, cos, 0.0), dim=-1)


class Template(NamedTuple):
    offsets: torch.Tensor  # (F, 2) feature offsets (dy, dx) from the window's top left
    orientations: torch.Tensor  # (F,) int bins
    size: tuple  # (h, w)


def extract_template(quantized: torch.Tensor, mag: torch.Tensor, top_left, size, n_features: int = 32) -> Template:
    """The n_features strongest-gradient quantised pixels of the box as the
    template's features (Modality::extractTemplate)."""
    y0, x0 = top_left
    h, w = size
    q = quantized[y0:y0 + h, x0:x0 + w]
    m = mag[y0:y0 + h, x0:x0 + w] * (q.sum(-1) > 0)
    top = np.argsort(-m.cpu().numpy().reshape(-1))[:n_features]
    oy, ox = np.unravel_index(top, (h, w))
    ori = q.argmax(-1).cpu().numpy()[oy, ox]
    dev = quantized.device
    return Template(torch.from_numpy(np.stack([oy, ox], 1).astype(np.int32)).to(dev),
                    torch.from_numpy(ori.astype(np.int32)).to(dev), (int(h), int(w)))


def match_template(resp: torch.Tensor, tmpl: Template, stride: int = 2) -> torch.Tensor:
    """The template's score at every stride-th window position: the mean
    response of its features, (ny, nx) on [0, 1]. resp (H, W, 8) from
    response_maps."""
    H, W, _ = resp.shape
    h, w = tmpl.size
    dev = resp.device
    ys = torch.arange(0, H - h + 1, stride, device=dev)
    xs = torch.arange(0, W - w + 1, stride, device=dev)
    off = tmpl.offsets.to(dev).long()
    ori = tmpl.orientations.to(dev).long()
    ry = ys[:, None, None] + off[:, 0]  # (ny, 1, F)
    rx = xs[None, :, None] + off[:, 1]  # (1, nx, F)
    return resp[ry, rx, ori].mean(-1)


def detect(img, tmpl: Template, spread_T: int = 4, stride: int = 2, thresh: float = 0.8):
    """The colour-gradient detection pass on img (a tensor, or host data,
    which runs on the CPU): (boxes (N, 4) y0, x0, y1, x1, scores (N,)) as
    numpy arrays, one copy to the host."""
    img = torch.as_tensor(img, dtype=torch.float32)
    q, _ = quantize_gradients(img)
    s = match_template(response_maps(spread(q, spread_T)), tmpl, stride).cpu().numpy()
    ys, xs = np.where(s >= thresh)
    h, w = tmpl.size
    boxes = np.stack([ys * stride, xs * stride, ys * stride + h, xs * stride + w], 1)
    return boxes, s[ys, xs]
