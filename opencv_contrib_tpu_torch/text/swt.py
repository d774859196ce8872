"""Stroke Width Transform text detection (the port of
opencv_contrib_tpu/text/swt.py).

Reference anchor: text/src/swt_text_detection.cpp (SWTTextDetection):
edge map -> per-edge-pixel ray cast along the gradient until an opposing
edge -> stroke width map -> letter candidates by stroke-width-consistent
connected components -> word grouping by geometric chaining.

All rays sample all steps at once (an (H, W, K) gather), the
first-opposing-edge test is an argmax, and the rays paint their widths by
a scatter minimum (order-free, so the same on every run). The letter
statistics are `ops.ccl.component_stats`, read by the host once; the word
chaining is the JAX version's host union-find."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.ccl import component_stats, connected_components
from opencv_contrib_tpu_torch.ops.image import sample_nearest
from opencv_contrib_tpu_torch.utils.device import as_float


def _edges(img: torch.Tensor, low: float = 0.08, high: float = 0.2):
    """Gradient-NMS edge map (Canny-class, single threshold pair) with one
    hysteresis dilation. Returns (edge, gy, gx, mag)."""
    g = filters.gaussian_blur(img.to(torch.float32), 1.0)
    gy, gx = filters.gradients(g)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    # quantize direction to 4 bins, compare against the two neighbors
    d = torch.remainder(torch.round(ang / (math.pi / 4)).to(torch.int32), 4)
    H, W = img.shape
    p = F.pad(mag, (1, 1, 1, 1))

    def nb(dy, dx):
        return p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    def select(maps):
        return torch.where(d == 0, maps[0], torch.where(d == 1, maps[1], torch.where(d == 2, maps[2], maps[3])))

    n0 = select([nb(0, 1), nb(1, 1), nb(1, 0), nb(1, -1)])
    n1 = select([nb(0, -1), nb(-1, -1), nb(-1, 0), nb(-1, 1)])
    nms = (mag >= n0) & (mag >= n1) & (mag > low)
    strong = mag > high
    # one hysteresis dilation pass: weak pixels next to strong survive
    sp = F.pad(strong, (1, 1, 1, 1))
    grow = torch.zeros_like(strong)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grow = grow | sp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    return nms & (strong | grow), gy, gx, mag


def stroke_width_map(img: torch.Tensor, max_width: int = 24, dark_on_light: bool = True) -> torch.Tensor:
    """SWT: per-pixel stroke width (0 where none). Rays cast from every
    edge pixel along +/-gradient; a hit is an edge pixel whose gradient
    opposes the ray within ~pi/6 (the reference's acceptance test)."""
    img = img.to(torch.float32)
    edge, gy, gx, mag = _edges(img)
    H, W = img.shape
    dev = img.device
    inv = torch.where(mag > 1e-6, 1.0 / torch.clamp(mag, min=1e-6), 0.0)
    dy, dx = gy * inv, gx * inv
    # dark-on-light: the gradient at a stroke edge points toward the bright
    # side, so the ray into the stroke marches along the NEGATIVE gradient
    sign = -1.0 if dark_on_light else 1.0
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    steps = torch.arange(1, max_width + 1, dtype=torch.float32, device=dev)
    ry = yy[..., None] + sign * dy[..., None] * steps  # (H, W, K)
    rx = xx[..., None] + sign * dx[..., None] * steps
    e_at = sample_nearest(edge.to(torch.float32), ry, rx) > 0.5
    gy_at = sample_nearest(gy, ry, rx)
    gx_at = sample_nearest(gx, ry, rx)
    # opposing gradient: cos(angle between) < -cos(pi/6)
    dot = gy_at * dy[..., None] + gx_at * dx[..., None]
    norm = torch.sqrt(gy_at ** 2 + gx_at ** 2) + 1e-6
    opposing = e_at & (dot / norm < -0.866)
    inb = (ry >= 0) & (ry < H) & (rx >= 0) & (rx < W)
    hit = opposing & inb
    any_hit = hit.any(-1)
    first = torch.argmax(hit.to(torch.uint8), dim=-1)  # index of the first hit step
    width = torch.where(edge & any_hit, steps[first], 0.0)

    # paint the stroke: the minimum width onto every pixel along the ray up
    # to the hit (the reference fills rays with the found width)
    kidx = torch.arange(max_width, device=dev)
    on_ray = (kidx[None, None] <= first[..., None]) & (edge & any_hit)[..., None] & inb
    py = torch.clamp(torch.round(ry), 0, H - 1).to(torch.int64)
    px = torch.clamp(torch.round(rx), 0, W - 1).to(torch.int64)
    flat = (py * W + px).reshape(-1)
    vals = torch.where(on_ray, width[..., None], float("inf")).reshape(-1)
    swt = torch.full((H * W,), float("inf"), device=dev).scatter_reduce_(0, flat, vals, "amin")
    swt = torch.where(torch.isfinite(swt), swt, 0.0).reshape(H, W)
    return torch.maximum(swt, torch.where(edge & any_hit, width, 0.0))


def _letter_stats(swt: torch.Tensor, max_components: int = 256) -> dict:
    mask = swt > 0
    labels, _ = connected_components(mask, connectivity=8)
    return component_stats(labels, values=swt, max_components=max_components)


def detect_text(img, max_width: int = 24, dark_on_light: bool = True, min_area: int = 10, max_aspect: float = 10.0,
                cv_thresh: float = 0.9):
    """SWT letter candidates -> word boxes. img a tensor (on the device it
    runs on) or host data (the CPU). Returns (boxes (N, 4) numpy
    [y0, x0, y1, x1], letter_boxes). Chaining (host-side, like the
    reference's letter pairing) merges candidates with similar stroke width
    and height along a line."""
    img = as_float(img)
    st = _letter_stats(stroke_width_map(img, max_width, dark_on_light))
    keys = ("area", "y0", "x0", "y1", "x1", "sum", "sumsq", "valid")
    host = torch.stack([st[k].to(torch.float32) for k in keys]).cpu().numpy()  # one copy
    area, y0, x0, y1, x1, ssum, ssq, valid = host
    valid = valid > 0
    mean = ssum / np.maximum(area, 1)
    var = ssq / np.maximum(area, 1) - mean ** 2
    h = y1 - y0 + 1
    w = x1 - x0 + 1
    keep = (
        valid
        & (area >= min_area)
        & (np.maximum(h / np.maximum(w, 1), w / np.maximum(h, 1)) < max_aspect)
        & (np.sqrt(np.maximum(var, 0)) / np.maximum(mean, 1e-6) < cv_thresh)
    )
    letters = np.stack([y0, x0, y1, x1, mean, h], axis=1)[keep]
    if letters.shape[0] == 0:
        return np.zeros((0, 4)), letters[:, :4]

    # chain letters into words: similar stroke width + height, horizontally near
    n = letters.shape[0]
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            a, b = letters[i], letters[j]
            sw_ratio = max(a[4], b[4]) / max(min(a[4], b[4]), 1e-6)
            h_ratio = max(a[5], b[5]) / max(min(a[5], b[5]), 1e-6)
            cy_a, cy_b = (a[0] + a[2]) / 2, (b[0] + b[2]) / 2
            gap = max(b[1] - a[3], a[1] - b[3])
            if (sw_ratio < 2.0 and h_ratio < 2.0 and abs(cy_a - cy_b) < 0.7 * max(a[5], b[5])
                    and gap < 2.0 * max(a[5], b[5])):
                parent[find(i)] = find(j)
    groups = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    boxes = []
    for members in groups.values():
        ls = letters[members]
        boxes.append([ls[:, 0].min(), ls[:, 1].min(), ls[:, 2].max(), ls[:, 3].max()])
    return np.asarray(boxes), letters[:, :4]
