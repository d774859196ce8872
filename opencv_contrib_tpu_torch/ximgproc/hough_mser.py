"""Hough circles, full-hysteresis Canny, and MSER regions (the port of
opencv_contrib_tpu/ximgproc/hough_mser.py).

Reference anchors (cudaimgproc):
- HoughCirclesDetector (cudaimgproc/src/cuda/hough_circles.cu): gradient-
  directed center voting + radius histogram per center.
- Canny (cudaimgproc/src/cuda/canny.cu): Sobel -> NMS -> double threshold
  -> hysteresis BFS.
- MSER (cudaimgproc MSER_CUDA / core mser.cpp): extremal regions stable
  across thresholds.

Canny's hysteresis is connected-component labelling of the weak mask
(ops.ccl); the circle votes are 0/1 weights, exact in any order; MSER labels
the n_levels level sets one after another (each CCL reads its stop flag
once a group of passes, a host sync) and keeps every level's statistics on
the device, read by the host in one copy for the association loop, which is
the JAX version's host code."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.ccl import component_stats, connected_components
from opencv_contrib_tpu_torch.text.swt import _edges
from opencv_contrib_tpu_torch.ximgproc.edges import _linspace
from opencv_contrib_tpu_torch.utils.device import as_float


def canny(img, low: float = 0.08, high: float = 0.2) -> torch.Tensor:
    """Full Canny: gradient NMS + double threshold + hysteresis: a weak
    pixel survives iff its 8-connected component of the weak mask contains
    a strong pixel.

    The JAX version marks the components by a scatter-set of `strong` at
    where(strong, root, 0), which XLA applies in index order: every root
    but 0 ends True iff its component holds a strong pixel, and slot 0 ends
    with the value of the last pixel that wrote it (the last pixel that is
    not strong or whose root is 0). Both are order-free here: a scatter
    maximum, and slot 0 taken from that last pixel."""
    nms, gy, gx, mag = _edges(as_float(img), low=low, high=low)
    weak = nms & (mag > low)
    strong = nms & (mag > high)
    H, W = mag.shape
    dev = mag.device
    labels, _ = connected_components(weak, connectivity=8)
    flat = labels.reshape(-1)
    safe = torch.where(flat >= 0, flat, 0).long()
    s = strong.reshape(-1)
    target = torch.where(s, safe, 0)
    has_strong = torch.zeros(H * W, dtype=torch.int32, device=dev).scatter_reduce_(0, target, s.to(torch.int32),
                                                                                    "amax")
    idx = torch.arange(H * W, device=dev)
    last0 = torch.amax(torch.where(target == 0, idx, -1))  # every pixel not strong writes slot 0
    has_strong[:1] = s.gather(0, torch.clamp(last0, min=0).reshape(1)).to(torch.int32)
    return weak & (has_strong[safe].reshape(H, W) > 0)


def hough_circles_accumulator(img, r_min: float = 8.0, r_max: float = 24.0, n_radii: int = 16,
                              mag_thresh: float = 0.1):
    """Gradient-directed circle voting: each edge pixel votes for centers
    at +-r along its gradient for every quantized radius. Returns the
    (n_radii, H, W) accumulator and the radii."""
    g = filters.gaussian_blur(as_float(img), 1.0)
    gy, gx = filters.gradients(g)
    mag = torch.sqrt(gy * gy + gx * gx)
    inv = 1.0 / torch.clamp(mag, min=1e-9)
    dy, dx = gy * inv, gx * inv
    H, W = g.shape
    dev = g.device
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    radii = _linspace(r_min, r_max, n_radii, device=dev)
    w = (mag > mag_thresh).to(torch.float32).reshape(-1)
    slots, votes = [], []
    for sgn in (1.0, -1.0):
        r = sgn * radii[:, None, None]
        cy = torch.clamp(torch.round(yy + r * dy), 0, H - 1).to(torch.int64)
        cx = torch.clamp(torch.round(xx + r * dx), 0, W - 1).to(torch.int64)
        slots.append((torch.arange(n_radii, device=dev)[:, None, None] * (H * W) + cy * W + cx).reshape(-1))
        votes.append(w.expand(n_radii, -1).reshape(-1))
    # 0/1 votes: float sums of small integers, exact in any order
    acc = torch.zeros(n_radii * H * W, device=dev).index_add_(0, torch.cat(slots), torch.cat(votes))
    return acc.reshape(n_radii, H, W), radii


def hough_circles(img, r_min: float = 8.0, r_max: float = 24.0, n_radii: int = 16, vote_frac: float = 0.5,
                  top_k: int = 8):
    """Detected circles (N, 3) [cy, cx, r] numpy (HoughCirclesDetector::detect);
    the accumulator is read by the host once."""
    acc, radii = hough_circles_accumulator(img, r_min, r_max, n_radii)
    a = acc.cpu().numpy()
    rads = radii.cpu().numpy()
    out = []
    thr = vote_frac * 2 * np.pi * rads  # votes ~ circumference when full circle present
    flat_order = np.argsort(-a, axis=None)
    taken = []
    for f in flat_order[: top_k * 20]:
        ri, y, x = np.unravel_index(f, a.shape)
        if a[ri, y, x] < thr[ri] * 0.25:
            break
        if any((y - t[0]) ** 2 + (x - t[1]) ** 2 < (0.5 * rads[ri]) ** 2 for t in taken):
            continue
        taken.append((y, x))
        out.append([float(y), float(x), float(rads[ri])])
        if len(out) >= top_k:
            break
    return np.asarray(out).reshape(-1, 3)


def _level_areas(img: torch.Tensor, n_levels: int = 24, max_components: int = 128):
    """Per level of n_levels thresholds: each component's area, box centre
    and validity, (n_levels, max_components) each, on the device."""
    lo, hi = img.min(), img.max()
    fr = torch.arange(1, n_levels + 1, device=img.device).to(torch.float32) / torch.full(
        (), float(n_levels + 1), device=img.device)
    ths = lo + fr * (hi - lo)
    rows = []
    for li in range(n_levels):
        labels, _ = connected_components(img <= ths[li], connectivity=4)
        st = component_stats(labels, max_components=max_components)
        rows.append(torch.stack([st["area"], (st["y0"] + st["y1"]) / 2.0, (st["x0"] + st["x1"]) / 2.0,
                                 st["valid"].to(torch.float32)]))
    return torch.stack(rows, 1)  # (4, n_levels, max_components)


def mser(img, n_levels: int = 24, max_components: int = 128, max_variation: float = 0.25, min_area: int = 20,
         max_area_frac: float = 0.25):
    """MSER regions: components whose area is stable (relative growth <
    max_variation) across adjacent threshold levels. Returns (N, 5) numpy
    [cy, cx, area, level, variation]."""
    img = as_float(img)
    H, W = img.shape
    areas, cys, cxs, valids = _level_areas(img, n_levels, max_components).cpu().numpy()  # one copy
    valids = valids > 0
    out = []
    for l in range(1, n_levels - 1):
        for i in np.where(valids[l])[0]:
            a, cy, cx = areas[l, i], cys[l, i], cxs[l, i]
            if a < min_area or a > max_area_frac * H * W:
                continue

            def nearest(lvl):
                ok = valids[lvl]
                if not ok.any():
                    return None
                # invalid slots carry +-inf centroids -> sanitize before
                # arithmetic (inf - inf = nan would poison argmin)
                cyl = np.nan_to_num(cys[lvl], posinf=1e6, neginf=-1e6)
                cxl = np.nan_to_num(cxs[lvl], posinf=1e6, neginf=-1e6)
                d = np.where(ok, (cyl - cy) ** 2 + (cxl - cx) ** 2, np.inf)
                j = int(np.argmin(d))
                return areas[lvl, j] if d[j] < (0.1 * (H + W)) ** 2 else None

            am = nearest(l - 1)
            ap = nearest(l + 1)
            if am is None or ap is None:
                continue
            var = abs(ap - am) / max(a, 1.0)
            if var < max_variation:
                out.append([cy, cx, a, l, var])
    # dedupe near-identical regions across levels (keep min variation)
    out.sort(key=lambda r: r[4])
    kept = []
    for r in out:
        if all((r[0] - k[0]) ** 2 + (r[1] - k[1]) ** 2 > 25 or abs(r[2] - k[2]) > 0.3 * k[2] for k in kept):
            kept.append(r)
    return np.asarray(kept).reshape(-1, 5)
