"""QR code encode / detect / decode — versions 1-40, all ECC levels,
numeric / alphanumeric / byte / kanji modes, per-block Reed-Solomon with
codeword interleaving.

Reference anchors: wechat_qrcode/src/* — the production pipeline is
SSD detector CNN -> super-resolution -> zxing decoder; here the detector is
the classical finder-pattern 1:1:3:1:1 ratio scan (zxing/qrcode/detector/
FinderPatternFinder.cpp semantics) done as a batched tensor scan, the
sampler is a projective module-grid gather (alignment-pattern refined for
higher versions), and the decoder mirrors zxing/qrcode/decoder/*:
format/version BCH (FormatInformation.cpp, Version.cpp), mask release
(DataMask.cpp), zigzag codeword read (BitMatrixParser.cpp), per-block RS
de-interleaving (DataBlock.cpp), and the segment-mode bit-stream parser
(DecodedBitStreamParser.cpp:50).

This is the port of opencv_contrib_tpu/wechat_qrcode/qr.py. The module
grid is sampled by one bilinear gather where the image lies (the card for
a CUDA tensor) and read back once a try; the finder scan, the bit plumbing
and the RS algebra stay on the host in numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.utils.device import as_float
from opencv_contrib_tpu_torch.wechat_qrcode import spec
from opencv_contrib_tpu_torch.wechat_qrcode.gf256 import rs_decode, rs_encode

# kept for the v1 API surface (older tests / callers)
N = 21
DATA_CW, EC_CW = 19, 7

_ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ $%*+-./:"

MODE_NUMERIC = 0b0001
MODE_ALNUM = 0b0010
MODE_BYTE = 0b0100
MODE_KANJI = 0b1000


def _pick_mode(text: str) -> int:
    if text and all(c.isdigit() for c in text):
        return MODE_NUMERIC
    if text and all(c in _ALNUM for c in text):
        return MODE_ALNUM
    try:
        sj = text.encode("shift_jis")
        if text and len(sj) == 2 * len(text) and all(
                0x8140 <= (sj[2 * i] << 8 | sj[2 * i + 1]) <= 0x9FFC or
                0xE040 <= (sj[2 * i] << 8 | sj[2 * i + 1]) <= 0xEBBF
                for i in range(len(text))):
            return MODE_KANJI
    except UnicodeEncodeError:
        pass
    return MODE_BYTE


def _encode_segment(text: str, mode: int, version: int):
    """Mode + count + payload bits for one segment."""
    bits = []

    def put(v, n):
        bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    put(mode, 4)
    cbits = spec.char_count_bits(mode, version)
    if mode == MODE_NUMERIC:
        put(len(text), cbits)
        for i in range(0, len(text), 3):
            chunk = text[i: i + 3]
            put(int(chunk), {3: 10, 2: 7, 1: 4}[len(chunk)])
    elif mode == MODE_ALNUM:
        put(len(text), cbits)
        for i in range(0, len(text), 2):
            chunk = text[i: i + 2]
            if len(chunk) == 2:
                put(_ALNUM.index(chunk[0]) * 45 + _ALNUM.index(chunk[1]), 11)
            else:
                put(_ALNUM.index(chunk[0]), 6)
    elif mode == MODE_KANJI:
        put(len(text), cbits)
        sj = text.encode("shift_jis")
        for i in range(0, len(sj), 2):
            v = (sj[i] << 8) | sj[i + 1]
            v -= 0x8140 if v <= 0x9FFC else 0xC140
            put((v >> 8) * 0xC0 + (v & 0xFF), 13)
    else:  # byte
        data = text.encode("utf-8")
        put(len(data), cbits)
        for b in data:
            put(b, 8)
    return bits


def _fits(text: str, mode: int, version: int, level: str) -> bool:
    n_bits = len(_encode_segment(text, mode, version))
    return n_bits <= spec.total_data_codewords(version, level) * 8


def choose_version(text: str, level: str = "L", mode: int | None = None) -> int:
    mode = mode if mode is not None else _pick_mode(text)
    for v in range(1, 41):
        if _fits(text, mode, v, level):
            return v
    raise ValueError("text too long for any QR version at level " + level)


def _interleave(block_data, block_ec):
    """Codeword interleaving across blocks (ISO 18004 8.6 / zxing
    DataBlock.cpp inverse)."""
    out = []
    for i in range(max(len(b) for b in block_data)):
        for b in block_data:
            if i < len(b):
                out.append(b[i])
    for i in range(max(len(b) for b in block_ec)):
        for b in block_ec:
            if i < len(b):
                out.append(b[i])
    return out


def encode(text: str, mask_id: int = 0, version: int | None = None,
           level: str = "L") -> np.ndarray:
    """Build a QR matrix (1 = dark). Auto-selects mode and (unless given)
    the smallest fitting version."""
    mode = _pick_mode(text)
    if version is None:
        version = choose_version(text, level, mode)
    assert _fits(text, mode, version, level), "payload too long for version"
    Nv = spec.dimension(version)
    n_data_cw = spec.total_data_codewords(version, level)

    bits = _encode_segment(text, mode, version)
    # terminator + pad to codeword boundary + pad codewords
    bits.extend([0] * min(4, n_data_cw * 8 - len(bits)))
    while len(bits) % 8:
        bits.append(0)
    cw = [sum(bits[i * 8 + j] << (7 - j) for j in range(8))
          for i in range(len(bits) // 8)]
    pad = [0xEC, 0x11]
    k = 0
    while len(cw) < n_data_cw:
        cw.append(pad[k % 2])
        k += 1

    # split into blocks, RS-encode each, interleave
    ec_per_block, groups = spec.ec_blocks(version, level)
    block_data, block_ec = [], []
    pos = 0
    for n_blocks, dcw in groups:
        for _ in range(n_blocks):
            blk = cw[pos: pos + dcw]
            pos += dcw
            full = rs_encode(blk, ec_per_block)
            block_data.append(blk)
            block_ec.append(full[dcw:])
    full = _interleave(block_data, block_ec)

    mod = spec.place_function_patterns(version)
    coords = spec.data_coords(version)
    bitstream = []
    for c in full:
        bitstream.extend((c >> (7 - j)) & 1 for j in range(8))
    bitstream += [0] * (len(coords) - len(bitstream))
    mfn = spec.MASKS[mask_id]
    for (y, x), b in zip(coords, bitstream):
        mod[y, x] = b ^ int(mfn(y, x))

    _write_format(mod, version, level, mask_id)
    if version >= 7:
        _write_version(mod, version)
    return mod


def _format_coord_lists(Nv):
    around = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7), (8, 8),
              (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]
    second = [(Nv - 1, 8), (Nv - 2, 8), (Nv - 3, 8), (Nv - 4, 8), (Nv - 5, 8),
              (Nv - 6, 8), (Nv - 7, 8), (8, Nv - 8), (8, Nv - 7), (8, Nv - 6),
              (8, Nv - 5), (8, Nv - 4), (8, Nv - 3), (8, Nv - 2), (8, Nv - 1)]
    return around, second


def _write_format(mod, version, level, mask_id):
    Nv = spec.dimension(version)
    f = spec.FORMAT_CODES[(level, mask_id)]
    fbits = [(f >> (14 - i)) & 1 for i in range(15)]
    around, second = _format_coord_lists(Nv)
    for (y, x), b in zip(around, fbits):
        mod[y, x] = b
    for (y, x), b in zip(second, fbits):
        mod[y, x] = b


def _write_version(mod, version):
    Nv = spec.dimension(version)
    v = spec.VERSION_CODES[version]
    for i in range(18):
        b = (v >> i) & 1
        mod[Nv - 11 + i % 3, i // 3] = b
        mod[i // 3, Nv - 11 + i % 3] = b


def render(mod: np.ndarray, scale: int = 4, border: int = 4) -> np.ndarray:
    """QR matrix -> grayscale image in [0, 1] (dark modules = 0)."""
    img = np.kron(mod, np.ones((scale, scale)))
    img = np.pad(img, border * scale, constant_values=0)
    return (1.0 - img).astype(np.float32)


# ---------------------------------------------------------------------------
# detection

def _find_finder_patterns(img, thresh: float = 0.5):
    """1:1:3:1:1 ratio scan of every row and column (batched run-length
    test at every pixel via distance-to-previous-transition arrays).
    Returns candidate centers (M, 2) float."""
    b = np.asarray(img) < thresh  # dark = True
    H, W = b.shape
    cands = []
    for axis, L in ((0, W), (1, H)):
        arr = b if axis == 0 else b.T
        for r in range(arr.shape[0]):
            row = arr[r]
            idx = np.flatnonzero(np.diff(row.astype(np.int8))) + 1
            runs = np.diff(np.r_[0, idx, len(row)])
            vals = row[np.r_[0, idx]]
            starts = np.r_[0, idx]
            for i in range(len(runs) - 4):
                if not vals[i]:
                    continue
                w = runs[i: i + 5].astype(float)
                u = w.sum() / 7.0
                if u < 1:
                    continue
                ok = (abs(w[0] - u) < 0.7 * u and abs(w[1] - u) < 0.7 * u
                      and abs(w[2] - 3 * u) < 1.5 * u and abs(w[3] - u) < 0.7 * u
                      and abs(w[4] - u) < 0.7 * u)
                if ok:
                    c = starts[i] + w[:2].sum() + w[2] / 2.0
                    cands.append((r, c, u) if axis == 0 else (c, r, u))
    if not cands:
        return np.zeros((0, 3))
    cands = np.asarray(cands, float)
    clusters = []
    for y, x, u in cands:
        placed = False
        for cl in clusters:
            if abs(cl[0] / cl[3] - y) < 3 * u and abs(cl[1] / cl[3] - x) < 3 * u:
                cl[0] += y
                cl[1] += x
                cl[2] += u
                cl[3] += 1
                placed = True
                break
        if not placed:
            clusters.append([y, x, u, 1])
    out = [(cl[0] / cl[3], cl[1] / cl[3], cl[2] / cl[3], cl[3]) for cl in clusters]
    out.sort(key=lambda t: -t[3])  # most scanline votes first
    return np.asarray(out[:8])


def _cross_check_center(img, y, x, u, thresh: float = 0.5, iters: int = 2):
    """Re-center a finder candidate on the middle of its central dark run
    along the row and column through it (zxing FinderPatternFinder::
    crossCheckHorizontal/Vertical). Robust to cluster contamination."""
    b = np.asarray(img) < thresh
    H, W = b.shape

    def center_1d(line, c, max_run):
        c = int(round(c))
        c = min(max(c, 0), len(line) - 1)
        if not line[c]:
            return None
        lo = c
        while lo > 0 and line[lo - 1] and c - lo < max_run:
            lo -= 1
        hi = c
        while hi < len(line) - 1 and line[hi + 1] and hi - c < max_run:
            hi += 1
        return 0.5 * (lo + hi)

    for _ in range(iters):
        cx = center_1d(b[int(round(min(max(y, 0), H - 1)))], x, 4 * u)
        if cx is None:
            return y, x
        x = cx
        cy = center_1d(b[:, int(round(min(max(x, 0), W - 1)))], y, 4 * u)
        if cy is None:
            return y, x
        y = cy
    return y, x


def _best_finder_triple(f):
    """Choose the most QR-like triple among the candidates: matching
    module sizes, equal right-angle arms (FinderPatternFinder::
    selectBestPatterns semantics)."""
    from itertools import combinations

    n = f.shape[0]
    if n == 3:
        return f[:3]
    best, best_score = None, np.inf
    for idx in combinations(range(n), 3):
        tri = f[list(idx)]
        us = tri[:, 2]
        u_spread = (us.max() - us.min()) / us.mean()
        tl, tr, bl = _order_finders(tri)
        a, b = tr - tl, bl - tl
        la, lb = np.linalg.norm(a), np.linalg.norm(b)
        if min(la, lb) < 10 * us.mean():
            arm_pen = 10.0  # arms must span at least version-1 geometry
        else:
            arm_pen = abs(la - lb) / max(la, lb)
        cosang = abs(np.dot(a, b)) / (la * lb + 1e-9)
        # vote count bonus: finders get many scanline hits
        votes = tri[:, 3].sum() if tri.shape[1] > 3 else 0.0
        score = 3 * u_spread + 2 * arm_pen + 2 * cosang - 0.01 * votes
        if score < best_score:
            best_score, best = score, tri
    return best


def _order_finders(f3):
    """Order three finder centers as (top-left, top-right, bottom-left)."""
    p = f3[:, :2]
    best, tl = -1, 0
    for i in range(3):
        a, b = p[(i + 1) % 3] - p[i], p[(i + 2) % 3] - p[i]
        c = abs(np.dot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)
        score = 1 - c
        if score > best:
            best, tl = score, i
    others = [j for j in range(3) if j != tl]
    a, b = p[others[0]] - p[tl], p[others[1]] - p[tl]
    if a[0] * b[1] - a[1] * b[0] > 0:
        others = others[::-1]
    return p[tl], p[others[0]], p[others[1]]


def _estimate_version(tl, tr, bl, module_u):
    """Version from finder spacing / module size (zxing
    Detector::computeDimension)."""
    d = 0.5 * (np.linalg.norm(tr - tl) + np.linalg.norm(bl - tl))
    dim = round(d / module_u) + 7
    # snap to the valid 4k+1 grid
    dim = int(dim)
    if dim % 4 == 0:
        dim += 1
    elif dim % 4 == 3:
        dim -= 2  # round to nearest valid below
    elif dim % 4 == 2:
        dim -= 1
    v = (dim - 17) // 4
    return int(np.clip(v, 1, 40))


def _perspective_from_4(src, dst):
    """3x3 homography mapping src (4, 2) -> dst (4, 2) (row, col order)."""
    A = []
    for (y, x), (v, u) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    A = np.asarray(A, float)
    _, _, Vt = np.linalg.svd(A)
    return Vt[-1].reshape(3, 3)


def _sample_grid(img, H_mat, Nv):
    """Sample the Nv x Nv module grid through homography H (module
    (x, y, 1) -> image (u, v, w), coords in (col=x, row=y)): one bilinear
    gather where `img` (a tensor) lies, read back once."""
    mody, modx = np.meshgrid(np.arange(Nv) + 0.5, np.arange(Nv) + 0.5,
                             indexing="ij")
    ones = np.ones_like(modx)
    p = np.stack([modx, mody, ones], axis=-1) @ H_mat.T
    u = p[..., 0] / p[..., 2]  # image col
    v = p[..., 1] / p[..., 2]  # image row
    uv = torch.as_tensor(np.stack([v, u]).astype(np.float32)).to(img.device)
    vals = sample_bilinear(img, uv[0], uv[1])
    return (vals < 0.5).to(torch.int32).cpu().numpy()


def _find_alignment_near(img, cy, cx, u, win=None):
    """Search a window around the expected bottom-right alignment pattern
    for its dark center (zxing AlignmentPatternFinder-lite): pick the
    dark pixel region centroid closest to the expectation."""
    win = win if win is not None else 4.0 * u
    H, W = img.shape
    y0, y1 = int(max(0, cy - win)), int(min(H, cy + win + 1))
    x0, x1 = int(max(0, cx - win)), int(min(W, cx + win + 1))
    if y1 - y0 < 3 or x1 - x0 < 3:
        return cy, cx
    patch = np.asarray(img[y0:y1, x0:x1]) < 0.5
    ys, xs = np.nonzero(patch)
    if len(ys) == 0:
        return cy, cx
    # weight dark pixels by closeness to the expectation
    d2 = (ys + y0 - cy) ** 2 + (xs + x0 - cx) ** 2
    w = np.exp(-d2 / (2 * u * u))
    return float(np.sum(ys * w) / np.sum(w)) + y0, float(np.sum(xs * w) / np.sum(w)) + x0


def detect_and_decode(img):
    """Full pipeline (WeChatQRCode::detectAndDecode, wechat_qrcode.hpp:24):
    find finder patterns, estimate version, sample the module grid through
    a projective transform (alignment-refined for v >= 2), decode.
    Returns (text or None, corners). The scans read one host copy of the
    image; the module grids are sampled where the image lies."""
    dev_img = as_float(img)
    img = dev_img.cpu().numpy()
    f = _find_finder_patterns(img)
    if f.shape[0] < 3:
        return None, None
    tri = _best_finder_triple(f)
    tl, tr, bl = _order_finders(tri)
    u = float(np.median(tri[:, 2]))
    # refine each finder center onto the middle of its central dark run
    # (scanline clusters can be pulled by nearby data-region false matches)
    tl = np.array(_cross_check_center(img, tl[0], tl[1], u))
    tr = np.array(_cross_check_center(img, tr[0], tr[1], u))
    bl = np.array(_cross_check_center(img, bl[0], bl[1], u))
    version = _estimate_version(tl, tr, bl, u)
    Nv = spec.dimension(version)

    # finder centers in module coords (x=col, y=row)
    src_mod = [(3.5, 3.5), (3.5, Nv - 3.5), (Nv - 3.5, 3.5)]  # (row, col)
    ex = (tr - tl) / (Nv - 7)
    ey = (bl - tl) / (Nv - 7)
    br_guess = tl + (Nv - 6.5) * ex + (Nv - 6.5) * ey
    if version >= 2:
        # bottom-right alignment pattern center sits at module coordinate
        # (Nv-6.5, Nv-6.5); tl's finder center is at (3.5, 3.5), so the
        # displacement is (Nv-10) module steps along each axis
        exp = tl + (Nv - 10.0) * ex + (Nv - 10.0) * ey
        ay, ax = _find_alignment_near(img, exp[0], exp[1], u)
        src4 = src_mod + [(Nv - 6.5, Nv - 6.5)]
        dst4 = [tl, tr, bl, np.array([ay, ax])]
    else:
        src4 = src_mod + [(Nv - 3.5, Nv - 3.5)]
        dst4 = [tl, tr, bl, tl + (Nv - 7) * ex + (Nv - 7) * ey]
    Hm = _perspective_from_4([(r, c) for r, c in src4],
                             [(p[0], p[1]) for p in dst4])
    corners = np.stack([tl, tr, bl])
    for v_try in {version, max(1, version - 1), min(40, version + 1)}:
        if v_try != version:
            # re-derive the grid transform at the alternative dimension
            Nv2 = spec.dimension(v_try)
            ex2 = (tr - tl) / (Nv2 - 7)
            ey2 = (bl - tl) / (Nv2 - 7)
            src4b = [(3.5, 3.5), (3.5, Nv2 - 3.5), (Nv2 - 3.5, 3.5),
                     (Nv2 - 3.5, Nv2 - 3.5)]
            dst4b = [tl, tr, bl, tl + (Nv2 - 7) * (ex2 + ey2)]
            Hm2 = _perspective_from_4(src4b, dst4b)
            mod = _sample_grid(dev_img, Hm2, Nv2)
        else:
            mod = _sample_grid(dev_img, Hm, Nv)
        text = decode_matrix(mod)
        if text is not None:
            return text, corners
    return None, corners


# ---------------------------------------------------------------------------
# matrix decoding

def decode_matrix(mod: np.ndarray):
    """Decode a sampled module matrix of any valid dimension (zxing
    Decoder::decode). Tries the 4 rotations. Returns text or None."""
    for rot in range(4):
        m = np.rot90(mod, rot)
        t = _decode_oriented(m)
        if t is not None:
            return t
    return None


def _read_format(mod):
    """Both format-info copies; best (level, mask) under BCH distance <= 3
    (zxing FormatInformation::decodeFormatInformation)."""
    Nv = mod.shape[0]
    around, second = _format_coord_lists(Nv)
    best = None
    for coordset in (around, second):
        fbits = 0
        for (y, x) in coordset:
            fbits = (fbits << 1) | int(mod[y, x])
        for (lvl, m), code in spec.FORMAT_CODES.items():
            d = bin(fbits ^ code).count("1")
            if d <= 3 and (best is None or d < best[0]):
                best = (d, lvl, m)
    return (best[1], best[2]) if best else (None, None)


def _read_version(mod):
    """Version from the matrix: the dimension determines it directly; the
    18-bit version info block (v >= 7) cross-checks / corrects."""
    Nv = mod.shape[0]
    v_dim = (Nv - 17) // 4
    if v_dim < 7:
        return v_dim
    vbits = 0
    for i in range(17, -1, -1):
        vbits = (vbits << 1) | int(mod[Nv - 11 + i % 3, i // 3])
    best = None
    for v, code in spec.VERSION_CODES.items():
        d = bin(vbits ^ code).count("1")
        if d <= 3 and (best is None or d < best[0]):
            best = (d, v)
    return best[1] if best else v_dim


def _deinterleave(cw, version, level):
    """Interleaved codeword stream -> per-block (data + ec) codeword lists
    (zxing DataBlock::getDataBlocks)."""
    ec_per_block, groups = spec.ec_blocks(version, level)
    sizes = []
    for n_blocks, dcw in groups:
        sizes.extend([dcw] * n_blocks)
    n_blocks = len(sizes)
    data_blocks = [[] for _ in range(n_blocks)]
    ec_blocks_ = [[] for _ in range(n_blocks)]
    it = iter(cw)
    for i in range(max(sizes)):
        for b in range(n_blocks):
            if i < sizes[b]:
                data_blocks[b].append(next(it))
    for i in range(ec_per_block):
        for b in range(n_blocks):
            ec_blocks_[b].append(next(it))
    return [(d, e) for d, e in zip(data_blocks, ec_blocks_)], ec_per_block


def _decode_oriented(mod):
    Nv = mod.shape[0]
    if Nv < 21 or (Nv - 17) % 4:
        return None
    version = _read_version(mod)
    if version is None or spec.dimension(version) != Nv:
        return None
    level, mask_id = _read_format(mod)
    if level is None:
        return None
    mfn = spec.MASKS[mask_id]
    coords = spec.data_coords(version)
    bits = [int(mod[y, x]) ^ int(mfn(y, x)) for (y, x) in coords]
    n_cw = spec.total_codewords(version)
    if len(bits) < n_cw * 8:
        return None
    cw = [sum(bits[i * 8 + j] << (7 - j) for j in range(8))
          for i in range(n_cw)]
    try:
        blocks, ec_per_block = _deinterleave(cw, version, level)
    except StopIteration:
        return None
    data = []
    for d, e in blocks:
        corrected, ok = rs_decode(list(d) + list(e), ec_per_block)
        if not ok:
            return None
        data.extend(int(c) for c in corrected)
    return _parse_bitstream(data, version)


def _parse_bitstream(data, version):
    """Segment-mode parser (zxing DecodedBitStreamParser.cpp:50): a
    sequence of (mode, count, payload) segments until terminator."""
    bits = []
    for c in data:
        bits.extend((c >> (7 - j)) & 1 for j in range(8))
    pos = 0
    out = []

    def take(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = (v << 1) | bits[pos]
            pos += 1
        return v

    try:
        while pos + 4 <= len(bits):
            mode = take(4)
            if mode == 0:  # terminator
                break
            if mode == MODE_NUMERIC:
                n = take(spec.char_count_bits(mode, version))
                while n >= 3:
                    out.append(f"{take(10):03d}")
                    n -= 3
                if n == 2:
                    out.append(f"{take(7):02d}")
                elif n == 1:
                    out.append(str(take(4)))
            elif mode == MODE_ALNUM:
                n = take(spec.char_count_bits(mode, version))
                while n >= 2:
                    v = take(11)
                    out.append(_ALNUM[v // 45] + _ALNUM[v % 45])
                    n -= 2
                if n == 1:
                    out.append(_ALNUM[take(6)])
            elif mode == MODE_BYTE:
                n = take(spec.char_count_bits(mode, version))
                raw = bytes(take(8) for _ in range(n))
                out.append(raw.decode("utf-8", errors="strict"))
            elif mode == MODE_KANJI:
                n = take(spec.char_count_bits(mode, version))
                raw = bytearray()
                for _ in range(n):
                    v = take(13)
                    v = ((v // 0xC0) << 8) | (v % 0xC0)
                    v += 0x8140 if v < 0x1F00 else 0xC140
                    raw.extend([(v >> 8) & 0xFF, v & 0xFF])
                out.append(raw.decode("shift_jis", errors="strict"))
            elif mode == 0b0111:  # ECI — read designator, keep parsing
                first = take(8)
                if first >> 7 == 1:
                    take(8) if first >> 6 == 0b10 else take(16)
            else:
                break
    except (IndexError, UnicodeDecodeError):
        return None
    text = "".join(out)
    return text if text else None
