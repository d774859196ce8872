"""BING objectness proposals (the port of opencv_contrib_tpu/saliency/bing.py).

Reference anchor: saliency/src/BING/ (ObjectnessBING: 8x8 binarized normed
gradients scored by a learned linear template over windows of quantized
sizes; saliencySpecializedClasses.hpp:86-143).

The normed-gradient map's summed-area table comes from
`ops.integral.integral` (one launch of the integral kernel on a CUDA
tensor); every window of every size is pooled to the 8x8 template grid by
box sums of that table, in one gather a size, and scored by one product
with the template. `objectness_boxes` reads the score maps back once and
ranks them on the host, as the twin does.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops import integral as integ
from opencv_contrib_tpu_torch.utils.device import as_float

TPL = 8  # canonical template size


def normed_gradients(img: torch.Tensor) -> torch.Tensor:
    gy, gx = filters.gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    return mag / (mag.max() + 1e-9)


def default_template(device="cpu") -> torch.Tensor:
    """Centre-surround objectness prior: objects have strong gradients along
    the window border (the learned BING template has this shape)."""
    t = np.zeros((TPL, TPL), np.float32)
    t[0, :] = t[-1, :] = t[:, 0] = t[:, -1] = 1.0
    t[1:-1, 1:-1] = -0.25
    return torch.as_tensor(t / np.abs(t).sum(), device=device)


def train_template(pos_windows, neg_windows, ridge: float = 1e-2) -> torch.Tensor:
    """Linear template from 8x8 normed-gradient windows (the reference's
    stage-1 SVM, trained here by ridge regression on the host)."""
    pos, neg = (np.asarray(w.detach().cpu() if isinstance(w, torch.Tensor) else w) for w in (pos_windows, neg_windows))
    X = np.concatenate([pos, neg]).reshape(-1, TPL * TPL)
    y = np.concatenate([np.ones(len(pos)), -np.ones(len(neg))])
    w = np.linalg.solve(X.T @ X + ridge * np.eye(TPL * TPL), X.T @ y)
    return torch.as_tensor(w.reshape(TPL, TPL).astype(np.float32))


def score_windows(img, template, sizes=(16, 32, 64), stride: int = 8) -> dict:
    """Score all windows of each size: {size: (ny, nx) score map}. A window
    is pooled to 8x8 cells by box sums of the summed-area table, then dotted
    with the template."""
    img = as_float(img)
    dev = img.device
    template = as_float(template).to(dev)
    ng = normed_gradients(img)
    H, W = ng.shape
    ii = integ.integral(ng)
    out = {}
    for size in sizes:
        cell = size // TPL
        ys = torch.arange(0, H - size + 1, stride, device=dev)
        xs = torch.arange(0, W - size + 1, stride, device=dev)
        steps = torch.arange(TPL + 1, device=dev) * cell
        cy = ys[:, None] + steps  # (ny, 9)
        cx = xs[:, None] + steps  # (nx, 9)
        sub = ii[cy[:, None, :, None], cx[None, :, None, :]]  # (ny, nx, 9, 9)
        cells = sub[..., 1:, 1:] - sub[..., :-1, 1:] - sub[..., 1:, :-1] + sub[..., :-1, :-1]
        out[size] = (cells / (cell * cell) * template).sum(dim=(-2, -1))
    return out


def objectness_boxes(img, template=None, sizes=(16, 32, 64), stride: int = 8, top_k: int = 16):
    """BING-style proposals: the top-scoring windows across sizes. Returns
    (boxes (N, 4) [y0, x0, y1, x1], scores), host numpy as in the twin."""
    img = as_float(img)
    if template is None:
        template = default_template(img.device)
    maps = score_windows(img, template, sizes, stride)
    host = torch.cat([m.reshape(-1) for m in maps.values()]).cpu().numpy()  # one read for all sizes
    boxes, scores = [], []
    at = 0
    for size, m in maps.items():
        mn = host[at:at + m.numel()].reshape(m.shape)
        at += m.numel()
        ys, xs = np.unravel_index(np.argsort(-mn, axis=None)[: top_k // len(sizes) + 1], mn.shape)
        for y, x in zip(ys, xs):
            boxes.append([y * stride, x * stride, y * stride + size, x * stride + size])
            scores.append(float(mn[y, x]))
    order = np.argsort(-np.asarray(scores))[:top_k]
    return np.asarray(boxes)[order], np.asarray(scores)[order]
