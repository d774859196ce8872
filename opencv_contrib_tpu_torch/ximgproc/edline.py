"""EDLines / EDCircles: line and circle primitives from edge segments (the
port of opencv_contrib_tpu/ximgproc/edline.py).

Reference anchors: ximgproc/src/edge_drawing.cpp (EdgeDrawing: anchor
points + gradient-guided edge walking -> segments; EDLines least-squares
line fits with NFA validation; EDCircles arc joining + algebraic circle
fits).

The sequential pixel walks become connected components of the NMS edge
mask (ops.ccl); the per-component line and circle fits are closed-form
least squares over segment-summed moments (`ops.segment.segment_sum`: a
one-hot product on the card, the same bits on a rerun), read by the host in
one copy.

The moments are summed in float64 and rounded to float32, where the JAX
version sums in float32: its raw moments reach ~6e7 (y^2) and ~2e8
(y (y^2 + x^2)) on a VGA edge, and the fits subtract them (a line's
perpendicular spread is syy / n - cy^2), so float32 sums in another order
moved a fitted rms by ~0.5 px and let a marginal circle pass or fail (the
card against the CPU at VGA). Rounded float64 sums are the same on both
devices; at the JAX tests' sizes they equal the float32 sums (the sums are
integers below 2^24) and the tests hold the rest to a float64 recompute."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops.ccl import connected_components
from opencv_contrib_tpu_torch.ops.segment import segment_sum
from opencv_contrib_tpu_torch.text.swt import _edges
from opencv_contrib_tpu_torch.utils.device import as_float

MOMENTS = ("n", "sy", "sx", "syy", "sxx", "sxy", "syr", "sxr", "srr")


def _component_moments(img: torch.Tensor, max_components: int = 256) -> dict:
    """Edge mask -> per-component first/second moments (and the third
    moments of the circle fit), each (max_components,): components ranked
    in raster order of their roots, those past max_components dropped."""
    edge, gy, gx, mag = _edges(img)
    labels, _ = connected_components(edge, connectivity=8)
    H, W = img.shape
    dev = img.device
    flat = labels.reshape(-1)
    fg = flat >= 0
    idx = torch.arange(H * W, dtype=torch.int32, device=dev)
    is_root = fg & (flat == idx)
    rank = torch.cumsum(is_root.to(torch.int32), 0) - 1
    comp_of_root = torch.where(is_root, rank, 0)
    cid = torch.where(fg, comp_of_root[torch.where(fg, flat, 0).long()], max_components)
    cid = torch.clamp(cid, max=max_components)

    y = torch.arange(H, dtype=torch.float64, device=dev)[:, None].expand(H, W).reshape(-1)
    x = torch.arange(W, dtype=torch.float64, device=dev)[None, :].expand(H, W).reshape(-1)
    r2 = y * y + x * x
    vals = torch.stack([torch.ones_like(y), y, x, y * y, x * x, x * y, y * r2, x * r2, r2], 1)
    vals = torch.where(fg[:, None], vals, 0.0)
    sums = segment_sum(cid, vals, max_components + 1)[:max_components].to(torch.float32)
    return dict(zip(MOMENTS, sums.unbind(1)))


def _host_moments(img: torch.Tensor, max_components: int) -> dict:
    m = _component_moments(img, max_components)
    host = torch.stack([m[k] for k in MOMENTS]).cpu().numpy()  # one copy
    return dict(zip(MOMENTS, host))


def ed_lines(img, min_length: int = 12, max_fit_err: float = 1.0, max_components: int = 256):
    """Line segments from edge components: PCA line fit per component,
    accepted when the RMS point-line distance is small (EDLines' role).
    img a tensor (on the device it runs on) or host data (the CPU).
    Returns (N, 5) [y0, x0, y1, x1, rms_err] numpy."""
    m = _host_moments(as_float(img), max_components)
    n = m["n"]
    ok = n >= min_length
    out = []
    for i in np.where(ok)[0]:
        ni = n[i]
        cy, cx = m["sy"][i] / ni, m["sx"][i] / ni
        cyy = m["syy"][i] / ni - cy * cy
        cxx = m["sxx"][i] / ni - cx * cx
        cxy = m["sxy"][i] / ni - cx * cy
        C = np.array([[cyy, cxy], [cxy, cxx]])
        evals, evecs = np.linalg.eigh(C)
        rms = float(np.sqrt(max(evals[0], 0.0)))  # perpendicular spread
        if rms > max_fit_err:
            continue
        d = evecs[:, 1]  # principal direction (y, x)
        half = 2.0 * np.sqrt(max(evals[1], 0.0))
        p0 = np.array([cy, cx]) - d * half
        p1 = np.array([cy, cx]) + d * half
        out.append([p0[0], p0[1], p1[0], p1[1], rms])
    return np.asarray(out).reshape(-1, 5)


def ed_circles(img, min_points: int = 16, max_centroid_offset: float = 0.3, max_components: int = 256):
    """Circles from edge components via the Kasa algebraic fit on the
    component moments (EDCircles' role). Validation: a full circle's pixel
    centroid coincides with the fitted center, while lines and short arcs
    put the centroid ~r away. Returns (N, 3) [cy, cx, r] numpy."""
    img = as_float(img)
    m = _host_moments(img, max_components)
    n = m["n"]
    Hd = float(np.hypot(*img.shape))
    out = []
    for i in np.where(n >= min_points)[0]:
        ni = n[i]
        # Kasa fit: y^2 + x^2 = 2 cy y + 2 cx x + (r^2 - cy^2 - cx^2)
        A = np.array([
            [m["syy"][i], m["sxy"][i], m["sy"][i]],
            [m["sxy"][i], m["sxx"][i], m["sx"][i]],
            [m["sy"][i], m["sx"][i], ni],
        ])
        A[:, :2] *= 2.0  # the (cy, cx) columns carry the factor 2
        rhs = np.array([m["syr"][i], m["sxr"][i], m["srr"][i]])
        try:
            cy, cx, c0 = np.linalg.solve(A, rhs)
        except np.linalg.LinAlgError:
            continue
        r2 = c0 + cy * cy + cx * cx
        if r2 <= 0:
            continue
        r = np.sqrt(r2)
        centroid = np.array([m["sy"][i] / ni, m["sx"][i] / ni])
        offset = np.linalg.norm(centroid - [cy, cx])
        if r > Hd or offset > max_centroid_offset * r:
            continue
        out.append([cy, cx, r])
    return np.asarray(out).reshape(-1, 3)
