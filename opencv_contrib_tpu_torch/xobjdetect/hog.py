"""HOG descriptor + linear-SVM sliding-window detector (the port of
opencv_contrib_tpu/xobjdetect/hog.py).

Reference anchors: cudaobjdetect/src/hog.cpp + cuda/hog.cu (cuda::HOG:
compute_hists/normalize_hists/classify_hists kernels) and the classic
Dalal-Triggs layout: 8x8 cells, 9 unsigned orientation bins, 2x2-cell
blocks with L2-Hys normalization, 64x128 person window.

Cell histograms for the whole image come from one soft-binned one-hot sum;
block normalization is elementwise; the window descriptors are one strided
view of the block grid (windows row-major, then each window's blocks in
row-major order, as the twin's slices stack them); the SVM scores every
window at a scale in one matmul (classify_hists' role).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import resize
from opencv_contrib_tpu_torch.utils.device import as_float, to_device

N_BINS = 9
CELL = 8


def cell_histograms(img):
    """(H/8, W/8, 9) soft-binned gradient-orientation cell histograms."""
    gy, gx = filters.gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.remainder(torch.atan2(gy, gx) + math.pi, math.pi)  # unsigned [0, pi)
    bin_f = ang / math.pi * N_BINS
    lo = torch.remainder(torch.floor(bin_f).to(torch.int64), N_BINS)
    hi = torch.remainder(lo + 1, N_BINS)
    w_hi = bin_f - torch.floor(bin_f)
    H, W = img.shape
    hc, wc = H // CELL, W // CELL
    img_h, img_w = hc * CELL, wc * CELL

    def binmap(b, wgt):
        oh = F.one_hot(b[:img_h, :img_w], N_BINS).to(img.dtype) * (mag * wgt)[:img_h, :img_w, None]
        return oh.reshape(hc, CELL, wc, CELL, N_BINS).sum((1, 3))

    return binmap(lo, 1.0 - w_hi) + binmap(hi, w_hi)


def block_descriptors(cells):
    """2x2-cell blocks, L2-Hys normalized: (hc-1, wc-1, 36)."""
    b = torch.cat([cells[:-1, :-1], cells[:-1, 1:], cells[1:, :-1], cells[1:, 1:]], dim=-1)  # (hc-1, wc-1, 36)
    n = torch.sqrt((b * b).sum(-1, keepdim=True) + 1e-6)
    b = torch.clamp(b / n, max=0.2)
    n2 = torch.sqrt((b * b).sum(-1, keepdim=True) + 1e-6)
    return b / n2


def window_descriptors(blocks, win_cells=(16, 8), stride_cells: int = 1):
    """All window descriptors of the block grid (hb, wb, D), one strided
    view: (ny * nx, (win_h - 1) * (win_w - 1) * D), windows row-major and
    each window's blocks row-major; returns (descriptors, (ny, nx))."""
    hb, wb, D = blocks.shape
    wh, ww = win_cells[0] - 1, win_cells[1] - 1
    ny = (hb - wh) // stride_cells + 1
    nx = (wb - ww) // stride_cells + 1
    win = blocks.unfold(0, wh, stride_cells).unfold(1, ww, stride_cells)  # (ny, nx, D, wh, ww)
    return win.permute(0, 1, 3, 4, 2).reshape(ny * nx, -1), (ny, nx)


def hog_descriptor(img, win_cells=(16, 8)):
    """Single-window HOG descriptor of an image sized to the window
    (cuda::HOG::compute for one window)."""
    cells = cell_histograms(as_float(img))
    blocks = block_descriptors(cells)
    return blocks.reshape(-1)


def detect_multiscale(img, svm_w, svm_b: float = 0.0, win_cells=(16, 8), scales=(1.0, 0.84, 0.7),
                      score_thresh: float = 0.0):
    """Multi-scale sliding-window SVM detection: one matmul per scale.
    Returns (boxes (N, 4) [y0, x0, y1, x1] in original coords, float64,
    scores (N,)), tensors on the image's device, scale by scale and each
    scale's windows row-major, as the twin lists them. The result's size is
    read once, at the end."""
    img = as_float(img)
    w = to_device(svm_w, img.device)
    H, W = img.shape
    boxes, scores = [], []
    for s in scales:
        h, wd = int(H * s), int(W * s)
        if h < win_cells[0] * CELL or wd < win_cells[1] * CELL:
            continue
        im = resize(img, (h, wd)) if s != 1.0 else img
        desc, (ny, nx) = window_descriptors(block_descriptors(cell_histograms(im)), win_cells)
        sc = desc @ w + svm_b
        iy = torch.arange(ny, device=img.device, dtype=torch.float64)[:, None].expand(ny, nx).reshape(-1)
        ix = torch.arange(nx, device=img.device, dtype=torch.float64)[None, :].expand(ny, nx).reshape(-1)
        y0, x0 = iy * CELL / s, ix * CELL / s
        boxes.append(torch.stack([y0, x0, y0 + win_cells[0] * CELL / s, x0 + win_cells[1] * CELL / s], 1))
        scores.append(sc)
    if not scores:
        return torch.zeros((0, 4), dtype=torch.float64, device=img.device), torch.zeros(0, device=img.device)
    boxes, scores = torch.cat(boxes), torch.cat(scores)
    keep = torch.nonzero(scores > score_thresh).squeeze(1)  # the one read of the result's size
    return boxes.index_select(0, keep), scores.index_select(0, keep)
