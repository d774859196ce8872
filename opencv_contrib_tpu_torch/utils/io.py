"""Image and array IO — the port of opencv_contrib_tpu/utils/io.py.

Images are read and written by the port's own PNG codec (`utils/png.py`),
with the same results as the JAX package's PIL-backed functions for PNG
files: `imread` gives what `np.asarray(Image.open(path))` gives, as float32
in [0, 1] (a 16-bit gray file over 65535; a 16-bit colour file through its
high bytes, as PIL opens it), and `gray=True` converts as PIL's "L" mode
does. Any other format raises `NotImplementedError`: JPEG and the other
photo formats wait for the image-path item of ROADMAP.md.

The checkpoint store (named arrays and scalar attributes in an npz file, the
hdf module's contract) and the bundler-like reconstruction text format are
numpy and text, as in the JAX package; they take tensors too.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

from opencv_contrib_tpu_torch.utils import png


def _np(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _png_path(path: str) -> str:
    if os.path.splitext(str(path))[1].lower() != ".png":
        raise NotImplementedError(f"{path}: only PNG is read and written by the port (its own codec, "
                                  f"utils/png.py); JPEG and other formats wait for ROADMAP.md's image-path item")
    return path


def _pil_samples(arr: np.ndarray) -> np.ndarray:
    """The samples PIL gives for a decoded PNG: 16-bit gray stays 16-bit;
    16-bit colour (RGB, RGBA, gray + alpha) opens as 8-bit, its high bytes."""
    if arr.dtype == np.uint16 and arr.ndim == 3:
        return (arr >> 8).astype(np.uint8)
    return arr


def _to_gray(arr: np.ndarray) -> np.ndarray:
    """PIL's convert("L"): RGB(A) by its L24 rule (299/587/114 in 16-bit
    fixed point, rounded), gray + alpha by its gray, 16-bit gray clipped to
    255."""
    if arr.ndim == 2:
        return np.minimum(arr, 255).astype(np.uint8) if arr.dtype == np.uint16 else arr
    if arr.shape[-1] == 2:
        return arr[..., 0]
    rgb = arr[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def imread(path: str, gray: bool = False) -> np.ndarray:
    """Load an image as float32 in [0, 1] (H, W[, C])."""
    arr = _pil_samples(png.read(_png_path(path)))
    if gray:
        arr = _to_gray(arr)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    return arr.astype(np.float32) / 65535.0


def imread_depth_tum(path: str, scale: float = 5000.0) -> np.ndarray:
    """TUM RGB-D 16-bit PNG depth -> meters (0 = invalid)."""
    return png.read(_png_path(path)).astype(np.float32) / scale


def imwrite(path: str, img):
    """Write an image: float arrays are treated as [0, 1], uint8 as-is."""
    arr = _np(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    png.write(_png_path(path), arr)


# ----------------------------------------------------------------------------
# Checkpoint store (hdf-module parity at the API level)
# ----------------------------------------------------------------------------


def save_checkpoint(path: str, arrays: Mapping, attrs: Mapping | None = None):
    """Write named arrays (+ scalar attributes) — HDF5::dswrite/atwrite
    contract on an npz container."""
    payload = {k: _np(v) for k, v in arrays.items()}
    if attrs:
        for k, v in attrs.items():
            payload[f"__attr__{k}"] = _np(v)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str):
    """-> (arrays dict, attrs dict)."""
    data = np.load(path, allow_pickle=False)
    arrays, attrs = {}, {}
    for k in data.files:
        if k.startswith("__attr__"):
            attrs[k[len("__attr__"):]] = data[k]
        else:
            arrays[k] = data[k]
    return arrays, attrs


# ----------------------------------------------------------------------------
# Reconstruction export/import (bundler-format parity, sfm/src/io_bundler.h)
# ----------------------------------------------------------------------------


def export_reconstruction(path: str, Rs, ts, points, intr, registered=None, has_point=None):
    """Bundler-like text dump: header, per-camera f k1 k2 / R / t, points."""
    Rs, ts, points, intr = _np(Rs), _np(ts), _np(points), _np(intr)
    registered = np.ones(len(Rs), bool) if registered is None else _np(registered)
    has_point = np.ones(len(points), bool) if has_point is None else _np(has_point)
    cams = np.flatnonzero(registered)
    pts = np.flatnonzero(has_point)
    with open(path, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(cams)} {len(pts)}\n")
        for c in cams:
            f.write(f"{intr[0]} {intr[4]} {intr[5]}\n")
            for row in Rs[c]:
                f.write(" ".join(f"{x:.9g}" for x in row) + "\n")
            f.write(" ".join(f"{x:.9g}" for x in ts[c]) + "\n")
        for p in pts:
            f.write(" ".join(f"{x:.9g}" for x in points[p]) + "\n")
            f.write("255 255 255\n0\n")


def import_reconstruction(path: str):
    """-> (Rs (C,3,3), ts (C,3), points (P,3), f_k1_k2 (C,3))."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    n_cams, n_pts = map(int, lines[0].split())
    i = 1
    Rs, ts, intrs = [], [], []
    for _ in range(n_cams):
        intrs.append([float(x) for x in lines[i].split()])
        Rs.append([[float(x) for x in lines[i + r].split()] for r in (1, 2, 3)])
        ts.append([float(x) for x in lines[i + 4].split()])
        i += 5
    pts = []
    for _ in range(n_pts):
        pts.append([float(x) for x in lines[i].split()])
        i += 3
    return (np.array(Rs, np.float32), np.array(ts, np.float32), np.array(pts, np.float32),
            np.array(intrs, np.float32))
