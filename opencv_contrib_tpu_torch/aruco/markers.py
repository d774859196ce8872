"""Fiducial dictionary generation, rendering, and detection (the port of
opencv_contrib_tpu/aruco/markers.py). Dictionary generation, rendering,
the quad extraction and the dictionary lookup are the twin's numpy / scipy
on the host. The adaptive threshold is read once; every quad's homography
and cell samples are then one batched computation on the device, read
once (the twin reads each quad's samples in turn, with the same
arithmetic for each quad)."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.mvg import homography as hmod
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.utils.device import as_float, constant
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


def _rotations(code: np.ndarray):
    return [np.rot90(code, k) for k in range(4)]


def generate_dictionary(n_markers: int = 16, bits: int = 4, min_dist: int = 4, seed: int = 7):
    """Random dictionary with pairwise (rotation-minimal) Hamming distance
    >= min_dist: the generation recipe of cv::aruco::Dictionary."""
    rng = np.random.default_rng(seed)
    codes = []
    tries = 0
    while len(codes) < n_markers and tries < 20000:
        tries += 1
        cand = rng.integers(0, 2, size=(bits, bits)).astype(np.uint8)
        ok = True
        # self-rotation distinctness (so orientation is decodable)
        for k in range(1, 4):
            if np.sum(cand != np.rot90(cand, k)) < 1:
                ok = False
                break
        for c in codes:
            d = min(np.sum(r != cand) for r in _rotations(c))
            if d < min_dist:
                ok = False
                break
        if ok:
            codes.append(cand)
    if len(codes) < n_markers:
        raise RuntimeError("dictionary generation failed; lower min_dist")
    return np.stack(codes)


def draw_marker(dictionary: np.ndarray, marker_id: int, size_px: int = 64) -> np.ndarray:
    """Render marker `marker_id` with 1-module black border (white = 1.0)."""
    code = dictionary[marker_id]
    bits = code.shape[0]
    n = bits + 2
    grid = np.zeros((n, n), np.float32)
    grid[1:-1, 1:-1] = code
    cell = size_px // n
    return np.kron(grid, np.ones((cell, cell), np.float32))


def _find_quads(binary: np.ndarray, min_area: int = 100, max_area_frac: float = 0.9):
    """Candidate quads from connected components of the dark regions:
    corners = extremes of x+y / x-y within each component (host-side)."""
    from scipy import ndimage

    lab, n = ndimage.label(binary)
    quads = []
    H, W = binary.shape
    for i in range(1, n + 1):
        ys, xs = np.nonzero(lab == i)
        if len(ys) < min_area or len(ys) > max_area_frac * H * W:
            continue
        s = ys + xs
        d = ys - xs
        # corner order: TL, TR, BR, BL (in image coords)
        tl = np.array([ys[s.argmin()], xs[s.argmin()]])
        br = np.array([ys[s.argmax()], xs[s.argmax()]])
        tr = np.array([ys[d.argmin()], xs[d.argmin()]])
        bl = np.array([ys[d.argmax()], xs[d.argmax()]])
        quad = np.stack([tl, tr, br, bl]).astype(np.float32)
        # basic quad sanity: corners distinct and area consistent
        e = np.linalg.norm(np.roll(quad, -1, 0) - quad, axis=1)
        if e.min() < 4:
            continue
        quads.append(quad)
    return quads


def _cell_samples(img: torch.Tensor, quads: list, n: int) -> np.ndarray:
    """The n x n cell-centre samples of every quad's canonical square
    (Q, n, n), read to the host once: each quad's homography canonical ->
    image by the DLT (batched), the centres mapped through it."""
    size = 8 * n
    dev = img.device
    src = np.array([[0, 0], [0, size], [size, size], [size, 0]], np.float32)[:, ::-1]  # as (x, y)
    dst = np.stack([q[:, ::-1] for q in quads])  # (Q, 4, 2) as (x, y)
    cs = (np.arange(n) + 0.5) * 8
    gx, gy = np.meshgrid(cs, cs)
    pts = np.stack([gx.ravel(), gy.ravel(), np.ones(n * n)], axis=1).astype(np.float32)
    src_t = constant(np.broadcast_to(src, dst.shape).copy(), dev)
    with f32_matmul_precision():
        Hm = hmod.dlt(src_t, constant(dst, dev))  # (Q, 3, 3)
        q = constant(pts, dev) @ Hm.transpose(-1, -2)  # (Q, n*n, 3)
    q = q[..., :2] / q[..., 2:]
    return sample_bilinear(img, q[..., 1], q[..., 0]).reshape(len(quads), n, n).cpu().numpy()


def detect_markers(img, dictionary: np.ndarray, bits_per_side: int | None = None, thresh_C: float = 0.05):
    """Detect markers -> (ids list, corners list of (4, 2) [y, x] arrays).

    detectMarkers contract: adaptive threshold -> candidate quads ->
    perspective unwarp -> bit sampling -> dictionary lookup over rotations.
    img: a tensor (computed on its device) or host data (the CPU)."""
    img = as_float(img)
    if bits_per_side is None:
        bits_per_side = dictionary.shape[1]
    n = bits_per_side + 2

    # adaptive threshold (device): dark = below local mean - C
    local = filters.box_filter(img, 15)
    binary = (img < (local - thresh_C)).cpu().numpy()

    quads = _find_quads(binary)
    ids, corners = [], []
    if not quads:
        return ids, corners
    samples = _cell_samples(img, quads, n)
    for quad, vals in zip(quads, samples):
        # threshold bits at the mid-level of this patch
        t = (vals.min() + vals.max()) / 2.0
        grid = (vals > t).astype(np.uint8)
        # border must be black
        border = np.concatenate([grid[0], grid[-1], grid[1:-1, 0], grid[1:-1, -1]])
        if border.sum() > 1:
            continue
        code = grid[1:-1, 1:-1]
        found = None
        for mid in range(dictionary.shape[0]):
            for k in range(4):
                if np.array_equal(np.rot90(dictionary[mid], k), code):
                    found = (mid, k)
                    break
            if found:
                break
        if found:
            ids.append(found[0])
            corners.append(quad)
    return ids, corners
