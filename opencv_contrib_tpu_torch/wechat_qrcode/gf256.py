"""GF(256) arithmetic + Reed-Solomon codec for QR codes (the port's copy of
opencv_contrib_tpu/wechat_qrcode/gf256.py: host numpy, as there).

Reference anchor: wechat_qrcode/src/zxing/common/reedsolomon/* (the
vendored zxing GF256/ReedSolomonDecoder used by WeChatQRCode::decode).
Pure numpy — error correction is sequential polynomial algebra and runs
host-side in the reference too.
"""

from __future__ import annotations

import numpy as np

_PRIM = 0x11D  # QR code primitive polynomial x^8+x^4+x^3+x^2+1

EXP = np.zeros(512, np.int32)
LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    EXP[_i] = _x
    LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _PRIM
EXP[255:510] = EXP[:255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def gf_div(a: int, b: int) -> int:
    if a == 0:
        return 0
    return int(EXP[(LOG[a] - LOG[b]) % 255])


def poly_mul(p, q):
    out = np.zeros(len(p) + len(q) - 1, np.int32)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] ^= gf_mul(int(a), int(b))
    return out


def poly_eval(p, x: int) -> int:
    """Evaluate polynomial (highest-order first) at x."""
    y = 0
    for c in p:
        y = gf_mul(y, x) ^ int(c)
    return y


def rs_generator(n_ec: int):
    g = np.array([1], np.int32)
    for i in range(n_ec):
        g = poly_mul(g, [1, EXP[i]])
    return g


def rs_encode(data, n_ec: int):
    """Append n_ec Reed-Solomon codewords to data (list of ints)."""
    g = rs_generator(n_ec)
    msg = np.concatenate([np.asarray(data, np.int32), np.zeros(n_ec, np.int32)])
    for i in range(len(data)):
        c = int(msg[i])
        if c:
            for j in range(1, len(g)):
                msg[i + j] ^= gf_mul(int(g[j]), c)
    return list(np.asarray(data, np.int32)) + list(msg[len(data):])


def rs_decode(codewords, n_ec: int):
    """Correct up to n_ec//2 byte errors in-place (Berlekamp-Massey +
    Chien search + Forney). Returns (data, ok)."""
    msg = np.asarray(codewords, np.int32).copy()
    n = len(msg)
    synd = [poly_eval(msg, int(EXP[i])) for i in range(n_ec)]
    if max(synd) == 0:
        return list(msg[: n - n_ec]), True

    # Berlekamp-Massey
    err_loc = [1]
    old_loc = [1]
    for i in range(n_ec):
        delta = synd[i]
        for j in range(1, len(err_loc)):
            delta ^= gf_mul(err_loc[-(j + 1)], synd[i - j])
        old_loc = old_loc + [0]
        if delta != 0:
            if len(old_loc) > len(err_loc):
                new_loc = [gf_mul(c, delta) for c in old_loc]
                old_loc = [gf_div(c, delta) for c in err_loc]
                err_loc = new_loc
            err_loc = [0] * (len(old_loc) - len(err_loc)) + err_loc
            err_loc = [a ^ gf_mul(delta, b) for a, b in
                       zip(err_loc, [0] * (len(err_loc) - len(old_loc)) + old_loc)]
    while err_loc and err_loc[0] == 0:
        err_loc = err_loc[1:]
    n_err = len(err_loc) - 1
    if n_err * 2 > n_ec:
        return list(msg[: n - n_ec]), False

    # Chien search
    pos = []
    for i in range(n):
        if poly_eval(err_loc, int(EXP[(255 - i) % 255])) == 0:
            pos.append(n - 1 - i)
    if len(pos) != n_err:
        return list(msg[: n - n_ec]), False

    # Forney
    synd_poly = synd[::-1]
    err_eval = poly_mul(synd_poly[-n_ec:], err_loc)[-(n_err + 1):]
    for p in pos:
        xi = int(EXP[(n - 1 - p) % 255])  # locator X_j = alpha^(n-1-p)
        xi_inv = gf_div(1, xi)
        # derivative of err_loc at xi_inv
        d = 0
        loc_rev = err_loc[::-1]
        for j in range(1, len(loc_rev), 2):
            d ^= gf_mul(int(loc_rev[j]), int(EXP[(LOG[xi_inv] * (j - 1)) % 255]) if j > 1 else 1)
        num = poly_eval(err_eval, xi_inv)
        if d == 0:
            return list(msg[: n - n_ec]), False
        mag = gf_div(num, d)
        mag = gf_mul(mag, xi)
        msg[p] ^= mag
    ok = max(poly_eval(msg, int(EXP[i])) for i in range(n_ec)) == 0
    return list(msg[: n - n_ec]), ok
