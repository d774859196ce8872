"""DPM scoring: root + parts with quadratic deformation via max-plus GDT
(the port of opencv_contrib_tpu/dpm/detector.py).

Reference anchors: dpm/src/dpm_feature.cpp (Feature::computeFeaturePyramid),
dpm/src/dpm_convolution.cpp (ConvolutionEngine::convolve), dpm/src/dpm_model.cpp
(Model: rootFilters/partFilters/anchors/deformation), dpm/src/dpm_cascade.cpp
(detection loop + NMS).

The correlations run under `utils.precision.f32_matmul_precision` (cuDNN
takes TF32 by default on the card); a part's map is placed at its anchor by
index gathers on the device (the twin's `dynamic_slice`, with its clamped
start), so scoring a scale reads nothing back until `detect` thresholds it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops.image import resize
from opencv_contrib_tpu_torch.utils.device import as_float
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision
from opencv_contrib_tpu_torch.xobjdetect.hog import CELL, block_descriptors, cell_histograms


class DPMModel(NamedTuple):
    """One-component DPM: a root filter on the cell-feature grid plus P
    part filters with anchors (in root cells at 2x resolution) and
    quadratic deformation weights (dy2, dy, dx2, dx)."""

    root: torch.Tensor  # (rh, rw, D) filter over block descriptors
    parts: torch.Tensor  # (P, ph, pw, D)
    anchors: torch.Tensor  # (P, 2) part anchor (y, x) in part-grid cells
    deform: torch.Tensor  # (P, 4) quadratic costs (wy2, wy, wx2, wx), >= 0
    bias: float


def _features(img):
    """Block-normalized HOG grid (hb, wb, 36) — the DPM feature map."""
    return block_descriptors(cell_histograms(img))


def _correlate(feat, filt):
    """Valid cross-correlation of (H, W, D) with (fh, fw, D) -> (H-fh+1, W-fw+1)
    (`F.conv2d` correlates, as `lax.conv_general_dilated` does: the filter
    is not flipped)."""
    with f32_matmul_precision():
        return F.conv2d(feat.permute(2, 0, 1)[None], filt.permute(2, 0, 1)[None])[0, 0]


def gdt2d(score, deform, max_dy: int = 4, max_dx: int = 4):
    """Generalized distance transform (max-plus): out[y, x] =
    max_{dy, dx} score[y+dy, x+dx] - wy2*dy^2 - wy*|dy| - wx2*dx^2 - wx*|dx|.
    Separable: rows then columns; each axis is a max over static shifts
    (dpm's dt1d lower-envelope, reformulated branch-free)."""
    wy2, wy, wx2, wx = deform[0], deform[1], deform[2], deform[3]

    def axis_pass(s, k, w2, w1, axis):
        n = s.shape[axis]
        pad = (0, 0, k, k) if axis == 0 else (k, k)
        p = F.pad(s, pad, value=-torch.inf)
        stack = [p.narrow(axis, d + k, n) - w2 * d * d - w1 * abs(d) for d in range(-k, k + 1)]
        return torch.stack(stack).amax(0)

    out = axis_pass(score, max_dy, wy2, wy, 0)
    return axis_pass(out, max_dx, wx2, wx, 1)


def _place(pd_pad, start, H: int, W: int):
    """pd_pad[start[0]:start[0] + H, start[1]:start[1] + W] with `start` a
    device tensor, the start clamped into the map as `dynamic_slice`
    clamps it."""
    Hp, Wp = pd_pad.shape
    y0 = torch.clamp(start[0], 0, Hp - H)
    x0 = torch.clamp(start[1], 0, Wp - W)
    rows = y0 + torch.arange(H, device=pd_pad.device)
    cols = x0 + torch.arange(W, device=pd_pad.device)
    return pd_pad.index_select(0, rows).index_select(1, cols)


def score_scale(feat, model: DPMModel, max_disp: int = 4):
    """Total DPM score map at one pyramid scale (same grid for root and
    parts here; the reference places parts at 2x — absorbed into anchor
    units). Returns (H', W') root-anchored scores."""
    root_s = _correlate(feat, model.root)  # (hr, wr)
    H, W = root_s.shape
    total = root_s + model.bias
    anchors = model.anchors.to(torch.int64)
    for p in range(model.parts.shape[0]):
        ps = _correlate(feat, model.parts[p])  # (hp, wp)
        pd = gdt2d(ps, model.deform[p], max_disp, max_disp)
        # align part map to root coords at its anchor offset
        pd_pad = F.pad(pd, (0, feat.shape[1], 0, feat.shape[0]), value=-torch.inf)
        total = total + _place(pd_pad, anchors[p], H, W)
    return total


def detect(img, model: DPMModel, scales=(1.0, 0.8, 0.64), score_thresh: float = 0.0,
           max_disp: int = 4, nms_radius_cells: int = 3):
    """Multi-scale DPM detection. Returns list of (y, x, scale, score) with
    (y, x) the root top-left in pixels: each scale's map is read back once,
    and the greedy NMS runs on the host over a stable sort by score."""
    img = as_float(img)
    H, W = img.shape
    dets = []
    rh, rw = model.root.shape[:2]
    for s in scales:
        h, w = int(H * s), int(W * s)
        if h // CELL - 1 < rh + 2 or w // CELL - 1 < rw + 2:
            continue
        im = resize(img, (h, w)) if s != 1.0 else img
        feat = _features(im)
        sc = score_scale(feat, model, max_disp).cpu().numpy()
        ys, xs = np.where(sc > score_thresh)
        for y, x in zip(ys, xs):
            dets.append((y * CELL / s, x * CELL / s, s, float(sc[y, x])))
    # greedy NMS by score
    dets.sort(key=lambda d: -d[3])
    out = []
    r = nms_radius_cells * CELL
    for d in dets:
        if all(abs(d[0] - o[0]) > r or abs(d[1] - o[1]) > r for o in out):
            out.append(d)
    return out
