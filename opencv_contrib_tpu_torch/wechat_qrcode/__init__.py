"""QR code pipeline (the port of opencv_contrib_tpu/wechat_qrcode).

Parity target: wechat_qrcode/src/* (WeChatQRCode::detectAndDecode,
wechat_qrcode.hpp:24,51): detector -> sampler -> zxing-derived decoder with
Reed-Solomon correction. The classical finder-pattern ratio scan and
projective grid sampling stand for the reference's CNN detector (the zxing
fallback path); the decode stack covers versions 1-40, every ECC level and
mode. `spec` and `gf256` are the port's own copies of the twin's host
tables and codec. The twin's learned detector (`learned`) is not ported yet.
"""

from opencv_contrib_tpu_torch.wechat_qrcode import gf256, qr
from opencv_contrib_tpu_torch.wechat_qrcode.qr import decode_matrix, detect_and_decode, encode, render

__all__ = ["gf256", "qr", "encode", "render", "detect_and_decode", "decode_matrix"]
