"""Macbeth ColorChecker chart detection (the port of
opencv_contrib_tpu/mcc/detector.py).

Reference anchor: mcc/src/checker_detector.cpp (CCheckerDetector::process:
adaptive threshold -> contour candidates -> grid assembly by cell geometry
-> colour validation against the reference chart). mcc.hpp:129.

The threshold and the labelling run where the image lies (`ops.ccl` on the
card); the component statistics are read back once, and the lattice
RANSAC, the float64 DLT homography and the cell sampling run on the host
in numpy as in the twin, with the same `np.random.default_rng(seed)`
draws.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.mcc.ccm import MACBETH_SRGB, fit_ccm
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.ccl import component_stats, connected_components
from opencv_contrib_tpu_torch.utils.device import as_float

STAT_KEYS = ("area", "y0", "x0", "y1", "x1", "valid")


def find_chart_cells(img_gray, min_area: int = 30, max_components: int = 256):
    """Candidate chart cells: near-rectangular connected components of the
    regions the dark gutters separate. Returns host (centers (N, 2), boxes
    (N, 4))."""
    g = as_float(img_gray)
    # cells are separated by dark gutters: threshold above the local mean
    local = filters.box_filter(g, 9)
    mask = g > local + 0.01
    labels, _ = connected_components(mask, connectivity=4)
    st = component_stats(labels, max_components=max_components)
    host = torch.stack([st[k].to(torch.float32) for k in STAT_KEYS]).cpu().numpy()  # one read
    area, y0, x0, y1, x1 = host[:5]
    valid = host[5] > 0
    h, w = y1 - y0 + 1, x1 - x0 + 1
    with np.errstate(invalid="ignore"):
        fill = area / np.maximum(h * w, 1)
        # a square turned 45 degrees fills half its bounding box: the fill gate is loose so turned charts still yield
        keep = valid & (area >= min_area) & (fill > 0.4) & (
            np.maximum(h / np.maximum(w, 1), w / np.maximum(h, 1)) < 2.5)
    y0, x0, y1, x1 = y0[keep], x0[keep], y1[keep], x1[keep]  # the infinite rows go first
    centers = np.stack([(y0 + y1) / 2, (x0 + x1) / 2], 1)
    boxes = np.stack([y0, x0, y1, x1], 1)
    return centers, boxes


def _fit_homography_np(src, dst):
    """DLT homography src (N, 2) -> dst (N, 2), N >= 4 (host numpy; the
    assembly is small geometry like the reference's)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[0]
    A = np.zeros((2 * n, 9))
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    A[0::2, 0] = x
    A[0::2, 1] = y
    A[0::2, 2] = 1
    A[0::2, 6] = -u * x
    A[0::2, 7] = -u * y
    A[0::2, 8] = -u
    A[1::2, 3] = x
    A[1::2, 4] = y
    A[1::2, 5] = 1
    A[1::2, 6] = -v * x
    A[1::2, 7] = -v * y
    A[1::2, 8] = -v
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    return H / (H[2, 2] if abs(H[2, 2]) > 1e-12 else 1.0)


def _apply_h(H, pts):
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    w = np.where(np.abs(p[:, 2:]) < 1e-12, 1e-12, p[:, 2:])
    return p[:, :2] / w


def _assemble_lattice(centers, min_cells: int, rng):
    """Homography-consistent 4x6 grid assembly over candidate cell centers
    (the contour-quad graph assembly of checker_detector.cpp, re-posed as
    lattice RANSAC): seed a local basis from a cell and two near
    neighbors, integer-snap all centers, refine with a DLT homography,
    and accept the best window whose integer extent is 4x6 (either
    orientation) with >= min_cells member cells."""
    N = centers.shape[0]
    if N < min_cells:
        return None
    best = None
    d2 = ((centers[:, None] - centers[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    for seed in rng.permutation(N)[: min(N, 12)]:
        nb = np.argsort(d2[seed])[:6]
        for a in range(len(nb)):
            for b in range(a + 1, len(nb)):
                v1 = centers[nb[a]] - centers[seed]
                v2 = centers[nb[b]] - centers[seed]
                B = np.stack([v1, v2], axis=1)  # basis columns
                det = np.linalg.det(B)
                if abs(det) < 1e-6:
                    continue
                cos = abs(v1 @ v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
                if cos > 0.5:  # need near-orthogonal lattice directions
                    continue
                ij = np.linalg.solve(B, (centers - centers[seed]).T).T
                ij_r = np.round(ij)
                res = np.abs(ij - ij_r).max(axis=1)
                inl = res < 0.25
                if inl.sum() < min_cells:
                    continue
                # homography refinement: lattice ij -> image xy, resnap
                for _ in range(3):
                    H = _fit_homography_np(ij_r[inl], centers[inl])
                    Hi = np.linalg.inv(H)
                    ij2 = _apply_h(Hi, centers)
                    ij_r = np.round(ij2)
                    res = np.abs(ij2 - ij_r).max(axis=1)
                    inl = res < 0.3
                    if inl.sum() < min_cells:
                        break
                if inl.sum() < min_cells:
                    continue
                ii = ij_r[inl].astype(int)
                i0, j0 = ii.min(axis=0)
                ext = ii.max(axis=0) - ii.min(axis=0)
                # a 4x6 chart has integer extent (3,5) in some orientation
                if not ((ext[0] == 3 and ext[1] == 5)
                        or (ext[0] == 5 and ext[1] == 3)):
                    continue
                # unique cell occupancy (no two centers on one node)
                occ = {tuple(p) for p in ii}
                score = len(occ)
                if best is None or score > best[0]:
                    best = (score, H, (i0, j0), ext[0] == 5)
        if best is not None and best[0] >= 22:
            break
    return best


def _sample_cells(img, H, nodes):
    """Mean color per lattice node, sampled through the homography on a
    5x5 sub-cell offset pattern (missing/undetected cells still sample —
    the lattice knows where they are)."""
    Hh, Ww = img.shape[:2]
    offs = np.stack(np.meshgrid(np.linspace(-0.22, 0.22, 5),
                                np.linspace(-0.22, 0.22, 5)), -1).reshape(-1, 2)
    colors = np.zeros((len(nodes), 3), np.float32)
    for k, (i, j) in enumerate(nodes):
        pts = _apply_h(H, np.asarray([(i, j)], np.float64) + offs)
        # lattice -> centers space, and centers are (y, x) image coords
        yi = np.clip(np.round(pts[:, 0]).astype(int), 0, Hh - 1)
        xi = np.clip(np.round(pts[:, 1]).astype(int), 0, Ww - 1)
        colors[k] = img[yi, xi].mean(axis=0)
    return colors


def detect_chart(img_rgb, min_cells: int = 16, seed: int = 0):
    """Detect a 4x6 ColorChecker under rotation / perspective. Returns
    (patch_colors (24, 3) row-major or None, cell_centers), host numpy.

    Pipeline (CCheckerDetector::process, checker_detector.cpp): candidate
    cells -> homography-consistent lattice RANSAC (>= min_cells of 24
    suffice; a missing cell is sampled through the fitted homography) ->
    the orientation by correlation with the Macbeth reference colours. The
    gray image and the cells come from the image's device; the colours are
    sampled from one host copy of the image."""
    img = as_float(img_rgb)
    centers, boxes = find_chart_cells(img.mean(-1))
    fit = _assemble_lattice(centers, min_cells, np.random.default_rng(seed))
    if fit is None:
        return None, centers
    _, H, (i0, j0), transposed = fit
    img = img.cpu().numpy()

    # the 24 nodes in (row, col) chart order for each of the 4 orientation hypotheses, picked by correlation with the
    # reference
    ref = np.asarray(MACBETH_SRGB, np.float32)
    best_colors, best_corr = None, -np.inf
    for flip in range(4):
        nodes = []
        for r in range(4):
            for c in range(6):
                rr = 3 - r if flip & 1 else r
                cc = 5 - c if flip & 1 else c  # 180-degree rotation
                if flip & 2:
                    rr, cc = 3 - rr, cc  # mirror (non-physical, but tells charts seen through reflections apart)
                if transposed:
                    nodes.append((i0 + cc, j0 + rr))
                else:
                    nodes.append((i0 + rr, j0 + cc))
        cols = _sample_cells(img, H, nodes)
        a = cols - cols.mean(0)
        b = ref - ref.mean(0)
        corr = float((a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-9))
        if corr > best_corr:
            best_corr, best_colors = corr, cols
    return best_colors, centers


def detect_and_fit_ccm(img_rgb):
    """One call: detect the chart and fit the colour-correction matrix
    against the Macbeth reference (the reference's detector + CCM). Returns
    (M on the image's device, measured host (24, 3)) or (None, None)."""
    img = as_float(img_rgb)
    measured, _ = detect_chart(img)
    if measured is None:
        return None, None
    return fit_ccm(torch.as_tensor(measured, device=img.device), MACBETH_SRGB), measured
