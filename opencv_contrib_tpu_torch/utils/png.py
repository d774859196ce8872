"""A PNG codec of the port's own (the role libpng plays in the native IO
runtime of the JAX package, and PIL in its `utils/io.py`).

Decode: the signature, then the chunks; every chunk's CRC is checked with
`zlib.crc32`. The IDAT chunks are joined and inflated with `zlib`, and the
scanlines are unfiltered by a small host C++ routine
(`csrc/unfilter.cpp`, built at first use with the host compiler into
`build/kernels/host-<hash>/` and loaded with ctypes, which releases the GIL
while it runs). Bit depths 8 and 16 (big-endian samples) and colour types 0
(gray), 2 (RGB), 4 (gray + alpha) and 6 (RGBA) are read. A palette, a
depth below 8, Adam7 interlacing and a tRNS transparency chunk raise
`NotImplementedError` rather than give another image than the file holds.
If the unfilter cannot be built, decoding raises: nothing falls back.

`unfilter_numpy` is the same unfilter in numpy, row by row and, for Average
and Paeth, pixel by pixel: the tests and chip_smoke.py hold the C++ routine
to it.

Encode: 8- or 16-bit gray, gray + alpha, RGB or RGBA, every row with one
filter type (`filter` 0-4, Up by default), deflated with `zlib`.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
COLOR_TYPE = {v: k for k, v in CHANNELS.items()}
FILTERS = ("none", "sub", "up", "average", "paeth")
_SOURCE = Path(__file__).resolve().parent / "csrc" / "unfilter.cpp"
_P = ctypes.c_void_p


def unfilter_lib() -> ctypes.CDLL:
    """The host unfilter library, built at first use."""
    from opencv_contrib_tpu_torch.ops.cuda import _build

    return _build.build_host(_SOURCE, {"png_unfilter": [_P, _P, ctypes.c_int, ctypes.c_long, ctypes.c_int]})


def unfilter(buf: bytes, H: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The H x rowbytes unfiltered bytes of `buf`, H rows of one filter-type
    byte and `rowbytes` filtered bytes; `bpp` is the bytes of one whole pixel
    (the left neighbour's distance). Runs the host C++ routine."""
    src = np.frombuffer(buf, np.uint8)
    if src.size != H * (rowbytes + 1):
        raise ValueError(f"PNG: {src.size} bytes of image data, expected {H * (rowbytes + 1)}")
    out = np.empty((H, rowbytes), np.uint8)
    bad = unfilter_lib().png_unfilter(src.ctypes.data, out.ctypes.data, H, rowbytes, bpp)
    if bad:
        raise ValueError(f"PNG: unknown filter type {src[(bad - 1) * (rowbytes + 1)]} on row {bad - 1}")
    return out


def unfilter_numpy(buf: bytes, H: int, rowbytes: int, bpp: int) -> np.ndarray:
    """`unfilter` in numpy: None, Sub and Up by whole rows (Sub as a cumulative
    sum of each byte lane), Average and Paeth pixel by pixel."""
    src = np.frombuffer(buf, np.uint8).reshape(H, rowbytes + 1)
    out = np.zeros((H, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int32)
    for y in range(H):
        ftype, row = int(src[y, 0]), src[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = row
        elif ftype == 1:
            cur = row.copy()
            for lane in range(min(bpp, rowbytes)):
                cur[lane::bpp] = np.cumsum(row[lane::bpp]) & 0xFF
        elif ftype == 2:
            cur = (row + prev) & 0xFF
        elif ftype in (3, 4):
            cur = np.zeros(rowbytes, np.int32)
            for i in range(rowbytes):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (int(row[i]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype} on row {y}")
        out[y] = cur
        prev = cur.astype(np.int32)
    return out


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("PNG: bad signature")
    pos = 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("PNG: truncated chunk")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"PNG: truncated {ctype!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG: CRC mismatch in the {ctype.decode('latin-1')} chunk")
        yield ctype, body
        pos += 12 + n
        if ctype == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def decode(data: bytes) -> np.ndarray:
    """The samples of a PNG file's bytes: (H, W) for gray, (H, W, C) with C
    = 2, 3 or 4 otherwise; uint8 or uint16 by the bit depth."""
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"tRNS":
            raise NotImplementedError("PNG: tRNS transparency is not supported")
        elif ctype not in (b"IEND", b"PLTE") and ctype[0:1].isupper():
            raise ValueError(f"PNG: unknown critical chunk {ctype!r}")
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    W, H, depth, ctype, comp, filt, interlace = header
    if ctype == 3:
        raise NotImplementedError("PNG: palette images are not supported")
    if ctype not in CHANNELS:
        raise ValueError(f"PNG: bad colour type {ctype}")
    if depth not in (8, 16):
        raise NotImplementedError(f"PNG: bit depth {depth} is not supported (8 and 16 are)")
    if interlace:
        raise NotImplementedError("PNG: Adam7 interlacing is not supported")
    if comp or filt:
        raise ValueError(f"PNG: compression method {comp} / filter method {filt}")
    C, nb = CHANNELS[ctype], depth // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: bad image data: {e}") from e
    rows = unfilter(raw, H, W * C * nb, C * nb)
    img = rows.view(">u2").astype(np.uint16) if nb == 2 else rows
    return img.reshape(H, W) if C == 1 else img.reshape(H, W, C)


def read(path) -> np.ndarray:
    """`decode` of the file at `path`."""
    with open(path, "rb") as f:
        return decode(f.read())


def filter_rows(raw: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Filter every row of raw (H, rowbytes) uint8 with one filter type;
    returns (H, 1 + rowbytes) with the type byte in front of each row."""
    x = raw.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    elif ftype == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG: filter must be 0-4, got {ftype}")
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = ftype
    out[:, 1:] = (x - pred) & 0xFF
    return out


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def encode(img, filter: int = 2, level: int = 6) -> bytes:
    """PNG bytes of img: uint8 or uint16, (H, W) or (H, W, C) with C in
    1-4 (gray, gray + alpha, RGB, RGBA); every row filtered with `filter`."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG: encode takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if C not in COLOR_TYPE:
        raise ValueError(f"PNG: {C} channels")
    nb = img.dtype.itemsize
    raw = np.ascontiguousarray(img.astype(">u2") if nb == 2 else img).view(np.uint8).reshape(H, W * C * nb)
    ihdr = struct.pack(">IIBBBBB", W, H, 8 * nb, COLOR_TYPE[C], 0, 0, 0)
    body = zlib.compress(filter_rows(raw, C * nb, filter).tobytes(), level)
    return SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", body) + _chunk(b"IEND", b"")


def write(path, img, filter: int = 2) -> None:
    """`encode` img into the file at `path`."""
    data = encode(img, filter)
    with open(path, "wb") as f:
        f.write(data)
