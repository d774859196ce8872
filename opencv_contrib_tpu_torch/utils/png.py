"""A PNG codec of the port's own (the role libpng plays in the native IO
runtime of the JAX package, and PIL in its `utils/io.py`).

Decode: the signature, then the chunks; every chunk's CRC is checked with
`zlib.crc32`. The IDAT chunks are joined and inflated with `zlib`, and the
scanlines are unfiltered by a small host C++ routine
(`csrc/unfilter.cpp`, built at first use with the host compiler into
`build/kernels/host-<hash>/` and loaded with ctypes, which releases the GIL
while it runs). Every colour type and bit depth of the specification is
read: gray at 1, 2, 4, 8 and 16 bits, RGB, palette at 1-8 bits, gray +
alpha, RGBA, with a PLTE and a tRNS chunk, plain or Adam7-interlaced (each
pass unfiltered on its own and scattered into the image, as libpng's
`png_read_image` and PIL de-interlace). If the unfilter cannot be built,
decoding raises: nothing falls back.

`decode_raw` gives the file's samples as they are stored (unpacked, not
scaled) with the palette and the tRNS values; the two readers of the JAX
package see them differently, and each twin follows its own:
- `decode` (`utils.native.decode_png`) expands as libpng does under the
  native decode's setup (native/dataset_loader.cpp:64-66): a palette to RGB,
  gray of 1, 2 or 4 bits scaled to 8, and tRNS to an alpha channel (RGBA,
  or gray + alpha).
- `utils.io.imread` reads as PIL opens the file: palette indices, 1-bit gray
  as a bool array, 2- and 4-bit gray scaled to 0-255, tRNS ignored.

`unfilter_numpy` is the same unfilter in numpy, row by row and, for Average
and Paeth, pixel by pixel: the tests and chip_smoke.py hold the C++ routine
to it.

Encode: 8- or 16-bit gray, gray + alpha, RGB or RGBA, every row with one
filter type (`filter` 0-4, Up by default), deflated with `zlib`;
`encode_raw` writes any colour type and depth, with a PLTE, a tRNS and
Adam7 interlacing, unfiltered.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples a pixel -> colour type of `encode`
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
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


class PNGImage(NamedTuple):
    samples: np.ndarray  # (H, W) or (H, W, C): the stored samples, unpacked, unscaled; uint8 or uint16
    depth: int  # bits a sample: 1, 2, 4, 8 or 16
    color_type: int  # 0 gray, 2 RGB, 3 palette, 4 gray + alpha, 6 RGBA
    palette: np.ndarray | None  # (N, 3) uint8, from PLTE
    trns: np.ndarray | None  # tRNS: the palette's alphas (uint8), or the transparent gray / RGB (uint16)


def _unpack(rows: np.ndarray, w: int, C: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, rowbytes) as (h, w, C) samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * C].reshape(h, w, C)
    if depth == 16:
        return np.ascontiguousarray(rows[:, :w * C * 2]).view(">u2").astype(np.uint16).reshape(h, w, C)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[..., None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w * C].reshape(h, w, C)


def decode_raw(data: bytes) -> PNGImage:
    """The stored samples of a PNG file's bytes, its palette and tRNS."""
    header, idat, palette, trns_body = None, [], None, None
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            if len(body) % 3 or not 3 <= len(body) <= 768:
                raise ValueError(f"PNG: bad PLTE chunk of {len(body)} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif ctype == b"tRNS":
            trns_body = body
        elif ctype != b"IEND" and ctype[0:1].isupper():
            raise ValueError(f"PNG: unknown critical chunk {ctype!r}")
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    W, H, depth, ctype, comp, filt, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"PNG: bad colour type {ctype}")
    if depth not in DEPTHS[ctype]:
        raise ValueError(f"PNG: bit depth {depth} is not allowed for colour type {ctype}")
    if comp or filt or interlace > 1:
        raise ValueError(f"PNG: compression method {comp} / filter method {filt} / interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError("PNG: a palette image without a PLTE chunk")
    trns = None
    if trns_body is not None:  # libpng ignores a tRNS chunk on a type with alpha, as PIL does
        if ctype == 3:
            trns = np.frombuffer(trns_body, np.uint8).copy()
        elif ctype in (0, 2):
            if len(trns_body) != (2 if ctype == 0 else 6):
                raise ValueError(f"PNG: bad tRNS chunk of {len(trns_body)} bytes")
            trns = np.frombuffer(trns_body, ">u2").astype(np.uint16)
    C = CHANNELS[ctype]
    bits = C * depth
    bpp = max(1, bits // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: bad image data: {e}") from e
    dtype = np.uint16 if depth == 16 else np.uint8
    if not interlace:
        img = _unpack(unfilter(raw, H, (W * bits + 7) // 8, bpp), W, C, depth)
    else:
        img = np.zeros((H, W, C), dtype)
        off = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = (W - x0 + dx - 1) // dx, (H - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            rb = (pw * bits + 7) // 8
            n = ph * (rb + 1)
            if off + n > len(raw):
                raise ValueError(f"PNG: {len(raw)} bytes of image data, too few for the Adam7 passes")
            img[y0::dy, x0::dx] = _unpack(unfilter(raw[off:off + n], ph, rb, bpp), pw, C, depth)
            off += n
        if off != len(raw):
            raise ValueError(f"PNG: {len(raw)} bytes of image data, expected {off}")
    img = img.astype(dtype, copy=False)
    return PNGImage(img[..., 0] if C == 1 else img, depth, ctype, palette, trns)


def expand(raw: PNGImage) -> np.ndarray:
    """The samples libpng gives with the palette expanded to RGB, gray of
    1, 2 or 4 bits scaled to 8, and tRNS expanded to an alpha channel
    (png_set_palette_to_rgb, png_set_expand_gray_1_2_4_to_8,
    png_set_tRNS_to_alpha)."""
    s, depth, ctype, trns = raw.samples, raw.depth, raw.color_type, raw.trns
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)  # libpng's palette holds 256 entries, zero past PLTE's
        pal[:len(raw.palette)] = raw.palette
        rgb = pal[s]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:min(len(trns), 256)] = trns[:256]
        return np.concatenate([rgb, alpha[s][..., None]], axis=-1)
    top = 65535 if depth == 16 else 255
    dtype = np.uint16 if depth == 16 else np.uint8
    if ctype == 0:
        out = (s * (255 // ((1 << depth) - 1))).astype(np.uint8) if depth < 8 else s
        if trns is None:
            return out
        key = int(trns[0]) & ((1 << depth) - 1)
        alpha = np.where(s == key, 0, top).astype(dtype)
        return np.stack([out, alpha], axis=-1)
    if ctype == 2 and trns is not None:
        alpha = np.where((s == trns.astype(s.dtype)).all(-1), 0, top).astype(dtype)
        return np.concatenate([s, alpha[..., None]], axis=-1)
    return s


def decode(data: bytes) -> np.ndarray:
    """The samples of a PNG file's bytes as libpng expands them (`expand`):
    (H, W) for gray, (H, W, C) with C = 2, 3 or 4 otherwise; uint8 or
    uint16 by the bit depth."""
    return expand(decode_raw(data))


def read(path) -> np.ndarray:
    """`decode` of the file at `path`."""
    with open(path, "rb") as f:
        return decode(f.read())


def read_raw(path) -> PNGImage:
    """`decode_raw` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_raw(f.read())


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


def encode_raw(samples, depth: int, color_type: int, palette=None, trns=None, interlace: bool = False,
               level: int = 6) -> bytes:
    """PNG bytes of stored samples of any colour type and bit depth
    ((H, W) or (H, W, C), values below 2**depth), with a PLTE (N x 3 uint8)
    and a tRNS body (the palette's alphas, or the transparent gray / RGB
    value) when given, plain or Adam7-interlaced; every row unfiltered."""
    s = np.asarray(samples)
    if color_type not in CHANNELS or depth not in DEPTHS[color_type]:
        raise ValueError(f"PNG: colour type {color_type} at {depth} bits")
    C = CHANNELS[color_type]
    s = s.reshape(s.shape[0], s.shape[1], C)
    H, W = s.shape[:2]

    def rows(img):
        h, w = img.shape[:2]
        flat = img.reshape(h, w * C)
        if depth == 16:
            body = flat.astype(">u2").view(np.uint8).reshape(h, -1)
        elif depth == 8:
            body = flat.astype(np.uint8)
        else:
            per = 8 // depth
            pad = np.zeros((h, -(-w * C // per) * per), np.uint8)
            pad[:, :w * C] = flat
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
            body = (pad.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
        return np.concatenate([np.zeros((h, 1), np.uint8), body], axis=1).tobytes()

    if interlace:
        raw = b"".join(rows(s[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7
                       if W > x0 and H > y0)
    else:
        raw = rows(s)
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0, int(interlace)))]
    if palette is not None:
        chunks.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        body = (np.asarray(trns, np.uint8).tobytes() if color_type == 3
                else np.asarray(trns, ">u2").reshape(-1).tobytes())
        chunks.append(_chunk(b"tRNS", body))
    chunks.append(_chunk(b"IDAT", zlib.compress(raw, level)))
    return SIGNATURE + b"".join(chunks) + _chunk(b"IEND", b"")


def write(path, img, filter: int = 2) -> None:
    """`encode` img into the file at `path`."""
    data = encode(img, filter)
    with open(path, "wb") as f:
        f.write(data)
