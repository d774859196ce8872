"""Image and array IO — the port of opencv_contrib_tpu/utils/io.py.

Images are read and written by the port's own codecs, PNG (`utils/png.py`)
and baseline JPEG (`utils/jpeg.py`), with the same results as the JAX
package's PIL-backed functions: `imread` gives what
`np.asarray(Image.open(path))` gives, as float32 in [0, 1] (8-bit samples
over 255, a 16-bit gray file over 65535, a 16-bit colour file through its
high bytes, a 1-bit gray file as 0 / 1, a palette file as its indices over
255, 2- and 4-bit gray scaled to 0-255 as PIL's "L;2" / "L;4" do; tRNS
ignored), and `gray=True` converts as PIL's "L" mode does. `imwrite` writes
PNG, or JPEG at PIL's default quality 75 and 4:2:0. Any other format raises
`NotImplementedError`.

The checkpoint store (named arrays and scalar attributes in an npz file, the
hdf module's contract) and the bundler-like reconstruction text format are
numpy and text, as in the JAX package; they take tensors too.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

from opencv_contrib_tpu_torch.utils import jpeg, png

JPEG_EXTS = (".jpg", ".jpeg")


def _np(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _format(path) -> str:
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".png":
        return "png"
    if ext in JPEG_EXTS:
        return "jpeg"
    raise NotImplementedError(f"{path}: only PNG and JPEG are read and written by the port (its own codecs, "
                              f"utils/png.py and utils/jpeg.py)")


def _pil_png(raw: png.PNGImage) -> np.ndarray:
    """The samples PIL gives for a decoded PNG: a palette's indices; 1-bit
    gray as bool (mode "1"); 2- and 4-bit gray scaled to 0-255; 16-bit gray
    stays 16-bit; 16-bit colour (RGB, RGBA) opens as 8-bit, its high bytes,
    and 16-bit gray + alpha as RGBA (PIL's "LA;16B": the gray thrice)."""
    s = raw.samples
    if raw.color_type == 0 and raw.depth == 1:
        return s.astype(bool)
    if raw.color_type == 0 and raw.depth in (2, 4):
        return (s * (255 // ((1 << raw.depth) - 1))).astype(np.uint8)
    if s.dtype == np.uint16 and s.ndim == 3:
        s = (s >> 8).astype(np.uint8)
        return s[..., [0, 0, 0, 1]] if raw.color_type == 4 else s
    return s


def _pil_samples(path) -> tuple:
    """(the samples np.asarray(Image.open(path)) gives, the PNG palette or
    None)."""
    if _format(path) == "jpeg":
        return jpeg.read(path), None
    raw = png.read_raw(path)
    return _pil_png(raw), (raw.palette if raw.color_type == 3 else None)


def _l24(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _to_gray(arr: np.ndarray, palette=None) -> np.ndarray:
    """PIL's convert("L"): RGB(A) by its L24 rule (299/587/114 in 16-bit
    fixed point, rounded), a palette's colours by the same rule, 1-bit as
    0 / 255, gray + alpha by its gray, 16-bit gray clipped to 255."""
    if palette is not None:
        lut = np.zeros(256, np.uint8)
        lut[:len(palette)] = _l24(palette)
        return lut[arr]
    if arr.dtype == bool:
        return arr.astype(np.uint8) * np.uint8(255)
    if arr.ndim == 2:
        return np.minimum(arr, 255).astype(np.uint8) if arr.dtype == np.uint16 else arr
    if arr.shape[-1] == 2:
        return arr[..., 0]
    return _l24(arr)


def imread(path: str, gray: bool = False) -> np.ndarray:
    """Load an image as float32 in [0, 1] (H, W[, C])."""
    arr, palette = _pil_samples(path)
    if gray:
        arr = _to_gray(arr, palette)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def imread_depth_tum(path: str, scale: float = 5000.0) -> np.ndarray:
    """TUM RGB-D 16-bit PNG depth -> meters (0 = invalid)."""
    return _pil_samples(path)[0].astype(np.float32) / scale


def imwrite(path: str, img):
    """Write an image: float arrays are treated as [0, 1], uint8 as-is."""
    arr = _np(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if _format(path) == "jpeg":
        jpeg.write(path, arr)
    else:
        png.write(path, arr)


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
