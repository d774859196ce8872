"""Gray-code structured light: pattern generation and decoding (the port of
opencv_contrib_tpu/structured_light/graycode.py). Gray to binary is a
cumulative XOR along the bit planes, taken as a cumulative sum mod 2 (exact
in int32); the code words are weighted integer sums."""

from __future__ import annotations

import math

import torch


def generate_graycode_patterns(proj_w: int, proj_h: int):
    """All column+row gray-code bit patterns (+inverses), plus white/black.

    Returns (patterns (P, H, W) float 0/1, n_col_bits,
    n_row_bits) in the order [col bits, col bits inverted, row bits, row
    bits inverted, white, black] (GrayCodePattern::generate contract)."""
    ncb = int(math.ceil(math.log2(max(proj_w, 1))))
    nrb = int(math.ceil(math.log2(max(proj_h, 1))))
    x = torch.arange(proj_w, dtype=torch.int32)
    y = torch.arange(proj_h, dtype=torch.int32)
    gx = x ^ (x >> 1)
    gy = y ^ (y >> 1)
    pats = []
    for b in range(ncb - 1, -1, -1):
        pats.append(((gx >> b) & 1).to(torch.float32)[None, :].expand(proj_h, proj_w))
    for b in range(ncb - 1, -1, -1):
        pats.append((1.0 - ((gx >> b) & 1).to(torch.float32))[None, :].expand(proj_h, proj_w))
    for b in range(nrb - 1, -1, -1):
        pats.append(((gy >> b) & 1).to(torch.float32)[:, None].expand(proj_h, proj_w))
    for b in range(nrb - 1, -1, -1):
        pats.append((1.0 - ((gy >> b) & 1).to(torch.float32))[:, None].expand(proj_h, proj_w))
    pats.append(torch.ones((proj_h, proj_w)))
    pats.append(torch.zeros((proj_h, proj_w)))
    return torch.stack(pats), ncb, nrb


def _gray_to_binary(bits: torch.Tensor) -> torch.Tensor:
    """Gray code planes (B, H, W), MSB first -> binary planes: each plane
    is the XOR of itself and every plane before it."""
    return torch.cumsum(bits.to(torch.int32), dim=0, dtype=torch.int32) % 2


def _weighted(bin_planes: torch.Tensor) -> torch.Tensor:
    """sum_b 2^(B-1-b) plane_b in int32."""
    B = bin_planes.shape[0]
    w = torch.pow(2, torch.arange(B - 1, -1, -1, dtype=torch.int32, device=bin_planes.device))
    return torch.sum(w[:, None, None] * bin_planes, dim=0, dtype=torch.int32)


def decode_graycode(captured: torch.Tensor, n_col_bits: int, n_row_bits: int, thresh: float = 0.1):
    """Decode a captured pattern stack (same order as generate) into
    projector (col, row) int32 coordinates per camera pixel + validity mask.

    captured (P, H, W) float images."""
    ncb, nrb = n_col_bits, n_row_bits
    col_pos = captured[:ncb]
    col_inv = captured[ncb:2 * ncb]
    row_pos = captured[2 * ncb:2 * ncb + nrb]
    row_inv = captured[2 * ncb + nrb:2 * ncb + 2 * nrb]
    white = captured[-2]
    black = captured[-1]

    valid = (white - black) > thresh
    col = _weighted(_gray_to_binary(col_pos > col_inv))
    row = _weighted(_gray_to_binary(row_pos > row_inv))
    return col, row, valid
