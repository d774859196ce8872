"""Extremal-region (ER) text detection cascade (the port of
opencv_contrib_tpu/text/er.py).

Reference anchor: text/src/erfilter.cpp (Neumann-Matas): a component tree
over grayscale thresholds with incrementally computed features (area,
bbox, perimeter, Euler number / hole count, horizontal crossings) scored by
a two-stage classifier; the surviving regions are the character candidates.

Every threshold level is labelled on its own, all levels in one batch (the
twin vmaps over them): `ops.ccl.connected_components` of the (levels, H, W)
stack, each level frozen where its own loop would have stopped, one host
read of the stop flags a `ccl.PASSES_A_READ` passes. The perimeter and
Euler scatters add integer-valued floats, which sum exactly in any order.
The stage-1 probability and the cross-level NMS run on the host, as in the
twin; the features cross to the host in one copy."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.ops.ccl import component_stats, connected_components
from opencv_contrib_tpu_torch.utils.device import as_float

# XLA folds the twin's mean over the three rows, `crossings / 3.0`, into a product by float32(1 / 3), an ulp from a
# division on some sums
_THIRD = float(np.float32(1.0 / 3.0))
FEATURES = ("area", "y0", "x0", "y1", "x1", "valid", "perimeter", "euler", "crossings")


def _level_features(labels: torch.Tensor, max_components: int) -> dict:
    H, W = labels.shape
    dev = labels.device
    st = component_stats(labels, max_components=max_components)
    cid = st["cid_map"]  # (H, W) compact id, -1 on the background
    # perimeter: the 4-neighbour transitions out of each component
    p = F.pad(cid, (1, 1, 1, 1), value=-1)
    per = torch.zeros(max_components + 1, device=dev)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        nbr = p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        diff = (cid >= 0) & (nbr != cid)
        per = per.index_add(0, torch.where(diff, cid, max_components).reshape(-1).long(),
                            diff.reshape(-1).to(torch.float32))
    # Euler number by quad counts (Gray's formula): E = (Q1 - Q3 + 2 Qd) / 4, holes = 1 - E a component
    bq = (cid >= 0).to(torch.int32)
    pb = F.pad(bq, (1, 0, 1, 0))
    q = pb[:-1, :-1] + pb[:-1, 1:] + pb[1:, :-1] + pb[1:, 1:]
    qd = (pb[:-1, :-1] == pb[1:, 1:]) & (pb[:-1, 1:] == pb[1:, :-1]) & (pb[:-1, :-1] != pb[:-1, 1:])
    # each quad goes to the largest component id in it
    cpad = F.pad(cid, (1, 0, 1, 0), value=-1)
    quad_cid = torch.maximum(torch.maximum(cpad[:-1, :-1], cpad[:-1, 1:]), torch.maximum(cpad[1:, :-1], cpad[1:, 1:]))
    tgt = torch.where(quad_cid >= 0, quad_cid, max_components).reshape(-1).long()
    e = (q == 1).to(torch.float32) - (q == 3).to(torch.float32) + 2 * qd.to(torch.float32)
    euler = torch.zeros(max_components + 1, device=dev).index_add(0, tgt, e.reshape(-1))[:max_components] / 4.0
    # horizontal crossings at three heights (erfilter's incremental feature); an empty slot crosses nothing
    valid = st["valid"]
    y0 = torch.where(valid, st["y0"], 0.0).to(torch.int64)
    hgt = torch.where(valid, st["y1"] - st["y0"] + 1, 0.0).to(torch.int64)
    comp = torch.arange(max_components, device=dev)[:, None]
    crossings = torch.zeros(max_components, device=dev)
    for frac_n, frac_d in ((1, 6), (3, 6), (5, 6)):
        rows = torch.clamp(y0 + torch.div(hgt * frac_n, frac_d, rounding_mode="floor"), 0, H - 1)
        me = cid[rows] == comp  # (C, W)
        trans = (me[:, 1:] != me[:, :-1]).sum(-1) + me[:, 0] + me[:, -1]
        crossings = crossings + trans / 2.0
    return {"area": st["area"], "y0": st["y0"], "x0": st["x0"], "y1": st["y1"], "x1": st["x1"], "valid": valid,
            "perimeter": per[:max_components], "euler": euler, "crossings": crossings * _THIRD}


def er_level_features(img, n_levels: int = 16, max_components: int = 128, dark_on_light: bool = True) -> dict:
    """Label each threshold level and compute its regions' features.

    Returns a dict of (n_levels, max_components) tensors: area, bbox,
    perimeter, crossings (the mean horizontal crossings over 3 rows,
    erfilter.cpp's incremental feature) and the Euler number by 2x2 quad
    counts."""
    img = as_float(img)
    # evenly spaced gray-level thresholds over the image's range, in the twin's order and float32 (a pixel equal to a
    # threshold decides its mask)
    lo, hi = img.min(), img.max()
    fr = torch.arange(1, n_levels + 1, device=img.device) / (n_levels + 1)
    ths = lo + fr.to(img.dtype) * (hi - lo)
    masks = (img[None] <= ths[:, None, None]) if dark_on_light else (img[None] >= ths[:, None, None])
    labels, _ = connected_components(masks, connectivity=4)
    per_level = [_level_features(labels[i], max_components) for i in range(n_levels)]
    return {k: torch.stack([f[k] for f in per_level]) for k in FEATURES}


def _stage1_prob(feat):
    """Closed-form stage-1 classifier on the NM features: characters have
    moderate aspect, compact perimeter (low perimeter^2 / area), few holes
    and 1-4 horizontal crossings. A logistic surrogate of the reference's
    boosted trees (erfilter.cpp loadClassifierNM1); host numpy."""
    area = np.maximum(feat["area"], 1.0)
    h = feat["y1"] - feat["y0"] + 1
    w = feat["x1"] - feat["x0"] + 1
    aspect = np.maximum(h / np.maximum(w, 1), w / np.maximum(h, 1))
    compact = feat["perimeter"] ** 2 / area
    holes = np.maximum(1.0 - feat["euler"], 0.0)
    cross = feat["crossings"]
    z = (
        2.6
        - 0.25 * np.maximum(aspect - 4.0, 0)
        - 0.035 * np.maximum(compact - 20.0, 0)
        - 0.8 * np.abs(1.0 - feat["euler"])  # ragged / multi-hole shapes
        - 1.2 * np.maximum(holes - 2.0, 0)
        - 0.6 * np.maximum(cross - 4.0, 0)
        - 0.4 * np.maximum(1.0 - cross, 0)
    )
    return 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))


def er_detect(img, n_levels: int = 16, max_components: int = 128, dark_on_light: bool = True, min_prob: float = 0.5,
              min_area: int = 12, max_area_frac: float = 0.4, nms_iou: float = 0.6):
    """Run the ER cascade. Returns (boxes (N, 4) numpy [y0, x0, y1, x1],
    probs (N,)) after the cross-level NMS. The features are read back to the
    host in one copy."""
    img = as_float(img)
    H, W = img.shape
    feat = er_level_features(img, n_levels=n_levels, max_components=max_components, dark_on_light=dark_on_light)
    host = torch.stack([feat[k].to(torch.float32) for k in FEATURES]).cpu().numpy()
    feat = {k: host[i] for i, k in enumerate(FEATURES)}
    feat["valid"] = feat["valid"] > 0
    with np.errstate(invalid="ignore", over="ignore"):
        prob = _stage1_prob(feat)
    keep = feat["valid"] & (prob >= min_prob) & (feat["area"] >= min_area) & (feat["area"] <= max_area_frac * H * W)
    boxes = np.stack([feat["y0"], feat["x0"], feat["y1"], feat["x1"]], axis=-1)[keep]
    probs = prob[keep]
    if boxes.shape[0] == 0:
        return boxes.reshape(0, 4), probs
    # NMS across levels (duplicate branches of the component tree)
    order = np.argsort(-probs)
    chosen = []
    for i in order:
        ok = True
        for j in chosen:
            a, b = boxes[i], boxes[j]
            yy0, xx0 = max(a[0], b[0]), max(a[1], b[1])
            yy1, xx1 = min(a[2], b[2]), min(a[3], b[3])
            inter = max(yy1 - yy0 + 1, 0) * max(xx1 - xx0 + 1, 0)
            ua = (a[2] - a[0] + 1) * (a[3] - a[1] + 1) + (b[2] - b[0] + 1) * (b[3] - b[1] + 1) - inter
            if inter / max(ua, 1e-9) > nms_iou:
                ok = False
                break
        if ok:
            chosen.append(i)
    return boxes[chosen], probs[chosen]
