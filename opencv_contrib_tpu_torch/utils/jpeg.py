"""A baseline JPEG codec of the port's own (the role libjpeg plays in the
native IO runtime of the JAX package, and PIL in its `utils/io.py` and
`utils/video.py`).

The codec is host C++ (`csrc/jpeg.cpp`), built at first use with the host
compiler into `build/kernels/host-<hash>/` and loaded with ctypes, which
releases the GIL while it runs; it links no image library. If it cannot be
built, decoding and encoding raise: nothing falls back.

`decode` gives the samples libjpeg-turbo's default decompression gives (and
so PIL and the native decode): Huffman-coded sequential DCT (SOF0 / SOF1),
8-bit samples, 1 or 3 components, integral sampling ratios (2x1, 1x2 and
2x2 by "fancy" triangle upsampling, others by replication), restart
intervals, one or several scans, the islow IDCT and the fixed-point YCbCr
tables. Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and
4-component files raise `NotImplementedError` naming the mode; a corrupt
or truncated file raises `ValueError`.

`encode` writes what PIL's `save(..., "JPEG", quality=q)` writes for an RGB
or gray uint8 image: a JFIF APP0, libjpeg's standard tables scaled for the
quality, 4:2:0 by default (`subsampling` "4:4:4", "4:2:2", "4:4:0" or
"4:2:0"), and the standard Huffman tables.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "csrc" / "jpeg.cpp"
_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int

# luma (h, v) sampling factors by subsampling name; chroma is 1 x 1
SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:4:0": (1, 2), "4:2:0": (2, 2)}
ERRORS = {  # code -> (exception, message) of csrc/jpeg.cpp's codes
    1: (ValueError, "not a JPEG file (no SOI marker)"),
    2: (ValueError, "truncated marker segment"),
    3: (ValueError, "bad marker segment length"),
    4: (ValueError, "bad quantization table"),
    5: (ValueError, "bad Huffman table"),
    6: (ValueError, "bad frame header"),
    7: (ValueError, "bad scan header"),
    8: (ValueError, "a scan uses a table that was not defined"),
    9: (ValueError, "bad Huffman code in the scan data"),
    10: (ValueError, "premature end of the scan data"),
    11: (ValueError, "bad restart marker"),
    12: (ValueError, "no frame"),
    13: (ValueError, "bad arguments"),
    101: (NotImplementedError, "progressive JPEG is not supported (baseline sequential is)"),
    102: (NotImplementedError, "arithmetic-coded JPEG is not supported (Huffman is)"),
    103: (NotImplementedError, "lossless JPEG is not supported"),
    104: (NotImplementedError, "hierarchical JPEG is not supported"),
    105: (NotImplementedError, "12-bit (or 16-bit) JPEG samples are not supported (8-bit are)"),
    106: (NotImplementedError, "only 1- and 3-component JPEG is supported (not CMYK / YCCK)"),
    107: (NotImplementedError, "non-integral sampling ratios are not supported"),
    108: (NotImplementedError, "a DNL marker (height 0 in the frame header) is not supported"),
}


def codec_lib() -> ctypes.CDLL:
    """The host codec library, built at first use."""
    from opencv_contrib_tpu_torch.ops.cuda import _build

    return _build.build_host(_SOURCE, {"jpeg_decode": [_P, _L, _P, _P],
                                       "jpeg_encode": [_P, _I, _I, _I, _I, _I, _I, _P, _L, _P]})


def _raise(code: int) -> None:
    exc, msg = ERRORS.get(code, (ValueError, f"error {code}"))
    raise exc(f"JPEG: {msg}")


def decode(data: bytes) -> np.ndarray:
    """The samples of a JPEG file's bytes: uint8 (H, W) for one component,
    (H, W, 3) RGB for three."""
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(3, np.int32)
    lib = codec_lib()
    code = lib.jpeg_decode(buf.ctypes.data, buf.size, None, info.ctypes.data)
    if code:
        _raise(code)
    H, W, C = (int(v) for v in info)
    out = np.empty((H, W, C) if C > 1 else (H, W), np.uint8)
    code = lib.jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, info.ctypes.data)
    if code:
        _raise(code)
    return out


def read(path) -> np.ndarray:
    """`decode` of the file at `path`."""
    with open(path, "rb") as f:
        return decode(f.read())


def encode(img, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """JPEG bytes of img: uint8 (H, W) gray or (H, W, 3) RGB."""
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"JPEG: encode takes uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[-1] == 1:
        a = np.ascontiguousarray(a[..., 0])
    if not (a.ndim == 2 or (a.ndim == 3 and a.shape[-1] == 3)):
        raise ValueError(f"JPEG: encode takes (H, W) or (H, W, 3), got {a.shape}")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"JPEG: subsampling must be one of {sorted(SUBSAMPLING)}, got {subsampling!r}")
    H, W = a.shape[:2]
    C = 1 if a.ndim == 2 else 3
    hs, vs = SUBSAMPLING[subsampling]
    # at most 27 bits a coefficient, every byte stuffed, and the headers
    blocks = (-(-H // 8) + 1) * (-(-W // 8) + 1) * C
    cap = blocks * 440 + 4096
    out = np.empty(cap, np.uint8)
    size = ctypes.c_long(0)
    code = codec_lib().jpeg_encode(a.ctypes.data, H, W, C, int(quality), hs, vs, out.ctypes.data, cap,
                                   ctypes.byref(size))
    if code:
        _raise(code)
    if size.value > cap:
        raise RuntimeError(f"JPEG: {size.value} bytes overran the {cap}-byte buffer")
    return out[:size.value].tobytes()


def write(path, img) -> None:
    """`encode` img at quality 75 (PIL's default) into the file at `path`."""
    data = encode(img, 75)
    with open(path, "wb") as f:
        f.write(data)
