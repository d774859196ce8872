"""QR symbol-structure constants and geometry, versions 1-40 (the port's copy
of opencv_contrib_tpu/wechat_qrcode/spec.py: host numpy, as there).

The tables are ISO/IEC 18004 standard constants (the same data the
reference vendors in zxing/qrcode/version.cpp:55 buildVersions and
decoder/* use); everything derivable — dimensions, alignment grids,
function masks, zigzag order, total codewords — is computed, and the
computed totals cross-check the table (see _selfcheck).
"""

from __future__ import annotations

import numpy as np

# QR spec constants (ISO/IEC 18004): per version -> (alignment pattern
# centers, per-ECC-level (L,M,Q,H): (ec_cw_per_block, ((n_blocks, data_cw), ...)))
VERSION_TABLE = {
    1: ((), ((7, ((1, 19),)), (10, ((1, 16),)), (13, ((1, 13),)), (17, ((1, 9),)))),
    2: ((6, 18), ((10, ((1, 34),)), (16, ((1, 28),)), (22, ((1, 22),)), (28, ((1, 16),)))),
    3: ((6, 22), ((15, ((1, 55),)), (26, ((1, 44),)), (18, ((2, 17),)), (22, ((2, 13),)))),
    4: ((6, 26), ((20, ((1, 80),)), (18, ((2, 32),)), (26, ((2, 24),)), (16, ((4, 9),)))),
    5: ((6, 30), ((26, ((1, 108),)), (24, ((2, 43),)), (18, ((2, 15), (2, 16))), (22, ((2, 11), (2, 12))))),
    6: ((6, 34), ((18, ((2, 68),)), (16, ((4, 27),)), (24, ((4, 19),)), (28, ((4, 15),)))),
    7: ((6, 22, 38), ((20, ((2, 78),)), (18, ((4, 31),)), (18, ((2, 14), (4, 15))), (26, ((4, 13), (1, 14))))),
    8: ((6, 24, 42), ((24, ((2, 97),)), (22, ((2, 38), (2, 39))), (22, ((4, 18), (2, 19))), (26, ((4, 14), (2, 15))))),
    9: ((6, 26, 46), ((30, ((2, 116),)), (22, ((3, 36), (2, 37))), (20, ((4, 16), (4, 17))), (24, ((4, 12), (4, 13))))),
    10: ((6, 28, 50), ((18, ((2, 68), (2, 69))), (26, ((4, 43), (1, 44))), (24, ((6, 19), (2, 20))), (28, ((6, 15), (2, 16))))),
    11: ((6, 30, 54), ((20, ((4, 81),)), (30, ((1, 50), (4, 51))), (28, ((4, 22), (4, 23))), (24, ((3, 12), (8, 13))))),
    12: ((6, 32, 58), ((24, ((2, 92), (2, 93))), (22, ((6, 36), (2, 37))), (26, ((4, 20), (6, 21))), (28, ((7, 14), (4, 15))))),
    13: ((6, 34, 62), ((26, ((4, 107),)), (22, ((8, 37), (1, 38))), (24, ((8, 20), (4, 21))), (22, ((12, 11), (4, 12))))),
    14: ((6, 26, 46, 66), ((30, ((3, 115), (1, 116))), (24, ((4, 40), (5, 41))), (20, ((11, 16), (5, 17))), (24, ((11, 12), (5, 13))))),
    15: ((6, 26, 48, 70), ((22, ((5, 87), (1, 88))), (24, ((5, 41), (5, 42))), (30, ((5, 24), (7, 25))), (24, ((11, 12), (7, 13))))),
    16: ((6, 26, 50, 74), ((24, ((5, 98), (1, 99))), (28, ((7, 45), (3, 46))), (24, ((15, 19), (2, 20))), (30, ((3, 15), (13, 16))))),
    17: ((6, 30, 54, 78), ((28, ((1, 107), (5, 108))), (28, ((10, 46), (1, 47))), (28, ((1, 22), (15, 23))), (28, ((2, 14), (17, 15))))),
    18: ((6, 30, 56, 82), ((30, ((5, 120), (1, 121))), (26, ((9, 43), (4, 44))), (28, ((17, 22), (1, 23))), (28, ((2, 14), (19, 15))))),
    19: ((6, 30, 58, 86), ((28, ((3, 113), (4, 114))), (26, ((3, 44), (11, 45))), (26, ((17, 21), (4, 22))), (26, ((9, 13), (16, 14))))),
    20: ((6, 34, 62, 90), ((28, ((3, 107), (5, 108))), (26, ((3, 41), (13, 42))), (30, ((15, 24), (5, 25))), (28, ((15, 15), (10, 16))))),
    21: ((6, 28, 50, 72, 94), ((28, ((4, 116), (4, 117))), (26, ((17, 42),)), (28, ((17, 22), (6, 23))), (30, ((19, 16), (6, 17))))),
    22: ((6, 26, 50, 74, 98), ((28, ((2, 111), (7, 112))), (28, ((17, 46),)), (30, ((7, 24), (16, 25))), (24, ((34, 13),)))),
    23: ((6, 30, 54, 78, 102), ((30, ((4, 121), (5, 122))), (28, ((4, 47), (14, 48))), (30, ((11, 24), (14, 25))), (30, ((16, 15), (14, 16))))),
    24: ((6, 28, 54, 80, 106), ((30, ((6, 117), (4, 118))), (28, ((6, 45), (14, 46))), (30, ((11, 24), (16, 25))), (30, ((30, 16), (2, 17))))),
    25: ((6, 32, 58, 84, 110), ((26, ((8, 106), (4, 107))), (28, ((8, 47), (13, 48))), (30, ((7, 24), (22, 25))), (30, ((22, 15), (13, 16))))),
    26: ((6, 30, 58, 86, 114), ((28, ((10, 114), (2, 115))), (28, ((19, 46), (4, 47))), (28, ((28, 22), (6, 23))), (30, ((33, 16), (4, 17))))),
    27: ((6, 34, 62, 90, 118), ((30, ((8, 122), (4, 123))), (28, ((22, 45), (3, 46))), (30, ((8, 23), (26, 24))), (30, ((12, 15), (28, 16))))),
    28: ((6, 26, 50, 74, 98, 122), ((30, ((3, 117), (10, 118))), (28, ((3, 45), (23, 46))), (30, ((4, 24), (31, 25))), (30, ((11, 15), (31, 16))))),
    29: ((6, 30, 54, 78, 102, 126), ((30, ((7, 116), (7, 117))), (28, ((21, 45), (7, 46))), (30, ((1, 23), (37, 24))), (30, ((19, 15), (26, 16))))),
    30: ((6, 26, 52, 78, 104, 130), ((30, ((5, 115), (10, 116))), (28, ((19, 47), (10, 48))), (30, ((15, 24), (25, 25))), (30, ((23, 15), (25, 16))))),
    31: ((6, 30, 56, 82, 108, 134), ((30, ((13, 115), (3, 116))), (28, ((2, 46), (29, 47))), (30, ((42, 24), (1, 25))), (30, ((23, 15), (28, 16))))),
    32: ((6, 34, 60, 86, 112, 138), ((30, ((17, 115),)), (28, ((10, 46), (23, 47))), (30, ((10, 24), (35, 25))), (30, ((19, 15), (35, 16))))),
    33: ((6, 30, 58, 86, 114, 142), ((30, ((17, 115), (1, 116))), (28, ((14, 46), (21, 47))), (30, ((29, 24), (19, 25))), (30, ((11, 15), (46, 16))))),
    34: ((6, 34, 62, 90, 118, 146), ((30, ((13, 115), (6, 116))), (28, ((14, 46), (23, 47))), (30, ((44, 24), (7, 25))), (30, ((59, 16), (1, 17))))),
    35: ((6, 30, 54, 78, 102, 126, 150), ((30, ((12, 121), (7, 122))), (28, ((12, 47), (26, 48))), (30, ((39, 24), (14, 25))), (30, ((22, 15), (41, 16))))),
    36: ((6, 24, 50, 76, 102, 128, 154), ((30, ((6, 121), (14, 122))), (28, ((6, 47), (34, 48))), (30, ((46, 24), (10, 25))), (30, ((2, 15), (64, 16))))),
    37: ((6, 28, 54, 80, 106, 132, 158), ((30, ((17, 122), (4, 123))), (28, ((29, 46), (14, 47))), (30, ((49, 24), (10, 25))), (30, ((24, 15), (46, 16))))),
    38: ((6, 32, 58, 84, 110, 136, 162), ((30, ((4, 122), (18, 123))), (28, ((13, 46), (32, 47))), (30, ((48, 24), (14, 25))), (30, ((42, 15), (32, 16))))),
    39: ((6, 26, 54, 82, 110, 138, 166), ((30, ((20, 117), (4, 118))), (28, ((40, 47), (7, 48))), (30, ((43, 24), (22, 25))), (30, ((10, 15), (67, 16))))),
    40: ((6, 30, 58, 86, 114, 142, 170), ((30, ((19, 118), (6, 119))), (28, ((18, 47), (31, 48))), (30, ((34, 24), (34, 25))), (30, ((20, 15), (61, 16))))),
}

LEVELS = {"L": 0, "M": 1, "Q": 2, "H": 3}
# format-info level bits (ISO 18004 table 25)
LEVEL_BITS = {"L": 0b01, "M": 0b00, "Q": 0b11, "H": 0b10}


def dimension(version: int) -> int:
    return 17 + 4 * version


def alignment_centers(version: int):
    return VERSION_TABLE[version][0]


def ec_blocks(version: int, level: str):
    """(ec_cw_per_block, ((n_blocks, data_cw), ...))."""
    return VERSION_TABLE[version][1][LEVELS[level]]


def total_data_codewords(version: int, level: str) -> int:
    _, groups = ec_blocks(version, level)
    return sum(n * d for n, d in groups)


def total_codewords(version: int) -> int:
    ec, groups = ec_blocks(version, "L")
    return sum(n * (d + ec) for n, d in groups)


def _bch(value: int, poly: int, poly_bits: int, total_bits: int) -> int:
    """Append (total_bits - poly_bits + 1) BCH check bits to value."""
    v = value << (total_bits - poly_bits + 1)
    rem = v
    for i in range(total_bits - 1, poly_bits - 2, -1):
        if rem & (1 << i):
            rem ^= poly << (i - (poly_bits - 1))
    return v | rem


def format_bits(level: str, mask_id: int) -> int:
    """15-bit format info: 5 data bits + BCH(15,5) + mask 0x5412
    (zxing decoder/FormatInformation semantics)."""
    data = (LEVEL_BITS[level] << 3) | mask_id
    return _bch(data, 0b10100110111, 11, 15) ^ 0x5412


FORMAT_CODES = {(lvl, m): format_bits(lvl, m)
                for lvl in LEVELS for m in range(8)}


def version_bits(version: int) -> int:
    """18-bit version info (v >= 7): 6 data bits + BCH(18,6)."""
    return _bch(version, 0b1111100100101, 13, 18)


VERSION_CODES = {v: version_bits(v) for v in range(7, 41)}


def function_mask(version: int) -> np.ndarray:
    """True where a module is a function pattern: finders + separators,
    timing, format areas, dark module, alignment patterns, version info."""
    N = dimension(version)
    m = np.zeros((N, N), bool)
    for y0, x0 in ((0, 0), (0, N - 7), (N - 7, 0)):
        m[max(y0 - 1, 0): y0 + 8, max(x0 - 1, 0): x0 + 8] = True
    m[6, :] = True
    m[:, 6] = True
    m[8, :9] = True
    m[:9, 8] = True
    m[8, N - 8:] = True
    m[N - 8:, 8] = True  # includes the dark module at (N-8, 8)
    centers = alignment_centers(version)
    for cy in centers:
        for cx in centers:
            # skip the three finder corners
            if (cy <= 8 and cx <= 8) or (cy <= 8 and cx >= N - 9) or \
               (cy >= N - 9 and cx <= 8):
                continue
            m[cy - 2: cy + 3, cx - 2: cx + 3] = True
    if version >= 7:
        m[:6, N - 11: N - 8] = True
        m[N - 11: N - 8, :6] = True
    return m


def place_function_patterns(version: int) -> np.ndarray:
    """Module matrix with all function patterns drawn (1 = dark); data
    area zeroed."""
    N = dimension(version)
    mod = np.zeros((N, N), np.int32)

    def finder(y0, x0):
        mod[y0: y0 + 7, x0: x0 + 7] = 1
        mod[y0 + 1: y0 + 6, x0 + 1: x0 + 6] = 0
        mod[y0 + 2: y0 + 5, x0 + 2: x0 + 5] = 1

    finder(0, 0)
    finder(0, N - 7)
    finder(N - 7, 0)
    for i in range(8, N - 8):
        mod[6, i] = mod[i, 6] = (i + 1) % 2
    mod[N - 8, 8] = 1  # dark module
    centers = alignment_centers(version)
    for cy in centers:
        for cx in centers:
            if (cy <= 8 and cx <= 8) or (cy <= 8 and cx >= N - 9) or \
               (cy >= N - 9 and cx <= 8):
                continue
            mod[cy - 2: cy + 3, cx - 2: cx + 3] = 1
            mod[cy - 1: cy + 2, cx - 1: cx + 2] = 0
            mod[cy, cx] = 1
    return mod


def data_coords(version: int):
    """Zigzag module read order (zxing BitMatrixParser::readCodewords)."""
    N = dimension(version)
    func = function_mask(version)
    coords = []
    x = N - 1
    upward = True
    while x > 0:
        if x == 6:
            x -= 1
        ys = range(N - 1, -1, -1) if upward else range(N)
        for y in ys:
            for dx in (0, -1):
                if not func[y, x + dx]:
                    coords.append((y, x + dx))
        upward = not upward
        x -= 2
    return coords


MASKS = [
    lambda y, x: (y + x) % 2 == 0,
    lambda y, x: y % 2 == 0,
    lambda y, x: x % 3 == 0,
    lambda y, x: (y + x) % 3 == 0,
    lambda y, x: (y // 2 + x // 3) % 2 == 0,
    lambda y, x: (y * x) % 2 + (y * x) % 3 == 0,
    lambda y, x: ((y * x) % 2 + (y * x) % 3) % 2 == 0,
    lambda y, x: ((y + x) % 2 + (y * x) % 3) % 2 == 0,
]


def char_count_bits(mode: int, version: int) -> int:
    """Character-count field width (ISO 18004 table 3)."""
    idx = 0 if version <= 9 else (1 if version <= 26 else 2)
    return {
        0b0001: (10, 12, 14),  # numeric
        0b0010: (9, 11, 13),   # alphanumeric
        0b0100: (8, 16, 16),   # byte
        0b1000: (8, 10, 12),   # kanji
    }[mode][idx]


def _selfcheck():
    """Cross-check the transcribed table against computed geometry: the
    data area bit count must equal 8 * total codewords + remainder."""
    remainders = {1: 0, 2: 7, 3: 7, 4: 7, 5: 7, 6: 7, 7: 0}
    for v in range(1, 41):
        n_bits = len(data_coords(v))
        tot = total_codewords(v)
        rem = n_bits - 8 * tot
        assert 0 <= rem <= 7, (v, n_bits, tot)
        for lvl in LEVELS:
            ec, groups = ec_blocks(v, lvl)
            assert sum(n * (d + ec) for n, d in groups) == tot, (v, lvl)


_selfcheck()
