"""Block matching + semi-global matching on cost volumes (the port of
opencv_contrib_tpu/stereo/matching.py).

Census transform parity: stereo/src/descriptor.cpp (binary census kernels);
BM parity: StereoBinaryBM; SGM parity: StereoBinarySGBM's path aggregation
(simplified to 4 scan directions, P1/P2 penalties).

Each cost map is the twin's: the right image shifted by `torch.roll`'s rule
(one gather for all disparities), box-filtered by `ops.filters`' separable
pass in its order. Winners are the first minimum, as XLA's argmin takes it.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops import filters


def census_transform(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Census bit-string per pixel packed into int32 (window up to 5x5 -> 24
    bits); parity with the stereo module's census descriptors."""
    out = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    i = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            out = out | ((torch.roll(img, (dy, dx), (0, 1)) < img).to(torch.int32) << i)
            i += 1
    return out


def _shifted_stack(right: torch.Tensor, n: int) -> torch.Tensor:
    """(n, H, W): map d is `torch.roll(right, d, 1)`, the right image
    shifted so column x aligns with left x - d (one gather)."""
    W = right.shape[1]
    d = torch.arange(n, device=right.device)[:, None]
    x = torch.arange(W, device=right.device)[None, :]
    idx = torch.remainder(x - d, W)  # (n, W)
    return right[:, idx].permute(1, 0, 2)


def _box_maps(x: torch.Tensor, radius: int) -> torch.Tensor:
    """`filters.box_filter` of each map of (N, H, W), all in one pass."""
    n = 2 * radius + 1
    k = torch.full((n,), 1.0 / n, dtype=torch.float32, device=x.device)
    return filters._sep_filter_maps(x, k, k)


def cost_volume_sad(left, right, max_disp: int, block_radius: int = 3):
    """(D, H, W) SAD cost volume with box aggregation."""
    ad = torch.abs(left[None] - _shifted_stack(right, max_disp))
    return _box_maps(ad, block_radius)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def cost_volume_census(left, right, max_disp: int, radius: int = 2, agg_radius: int = 2):
    cl = census_transform(left, radius)
    cr = census_transform(right, radius)
    h = _popcount32(cl[None] ^ _shifted_stack(cr, max_disp)).to(torch.float32)
    return _box_maps(h, agg_radius)


def block_match(left, right, max_disp: int = 32, block_radius: int = 3, uniqueness: float = 1.05):
    """StereoBM-class: winner-take-all over the SAD volume + uniqueness gate.
    Returns (disparity (H, W) float32, valid (H, W))."""
    vol = cost_volume_sad(left, right, max_disp, block_radius)  # (D, H, W)
    disp = torch.argmin(vol, dim=0)
    best = torch.amin(vol, dim=0)
    # uniqueness: second-best (excluding +-1 neighborhood) must be clearly worse
    D = max_disp
    didx = torch.arange(D, device=vol.device)[:, None, None]
    near = torch.abs(didx - disp[None]) <= 1
    second = torch.amin(torch.where(near, torch.full_like(vol, float("inf")), vol), dim=0)
    valid = (second >= uniqueness * best) & (disp > 0) & (disp < D - 1)
    # parabolic sub-pixel refinement
    dm = torch.clamp(disp, 1, D - 2)
    c0 = torch.gather(vol, 0, (dm - 1)[None])[0]
    c1 = torch.gather(vol, 0, dm[None])[0]
    c2 = torch.gather(vol, 0, (dm + 1)[None])[0]
    denom = c0 - 2 * c1 + c2
    big = torch.abs(denom) > 1e-9
    offset = torch.where(big, 0.5 * (c0 - c2) / torch.where(big, denom, torch.ones_like(denom)),
                         torch.zeros_like(denom))
    return disp.to(torch.float32) + torch.clamp(offset, -0.5, 0.5), valid


def _sgm_scan(vol: torch.Tensor, axis: int, reverse: bool, P1: float, P2: float) -> torch.Tensor:
    """Directional DP along one image axis: L(d) = C(d) + min(Lp(d),
    Lp(d+-1)+P1, min_d Lp + P2) - min_d Lp. Every line across the axis
    steps at once; the steps run in Python, no host read among them."""
    v = torch.movedim(vol, axis + 1, 0)  # (S, D, L): the scan axis first
    if reverse:
        v = torch.flip(v, (0,))
    S, D, L = v.shape
    # Lp with a row of +inf above and below: the d+1 / d-1 neighbours are views
    pad = torch.full((D + 2, L), float("inf"), dtype=vol.dtype, device=vol.device)
    out = [v[0]]
    Lp = v[0]
    for s in range(1, S):
        pad[1:-1] = Lp
        m = torch.amin(Lp, dim=0)
        L_ = v[s] + torch.minimum(torch.minimum(Lp, torch.minimum(pad[2:], pad[:-2]) + P1), m[None] + P2) - m[None]
        out.append(L_)
        Lp = L_
    out = torch.stack(out)
    if reverse:
        out = torch.flip(out, (0,))
    return torch.movedim(out, 0, axis + 1)


def sgm_aggregate(vol: torch.Tensor, P1: float = 1.0, P2: float = 8.0) -> torch.Tensor:
    """4-direction SGM aggregation (left/right/up/down scans), summed in
    the twin's order."""
    return (_sgm_scan(vol, 1, False, P1, P2) + _sgm_scan(vol, 1, True, P1, P2)
            + _sgm_scan(vol, 0, False, P1, P2) + _sgm_scan(vol, 0, True, P1, P2))


def sgm_match(left, right, max_disp: int = 32, census_radius: int = 2, P1: float = 1.0, P2: float = 8.0):
    """StereoSGBM-class census + SGM pipeline -> (disparity, valid)."""
    vol = cost_volume_census(left, right, max_disp, census_radius)
    agg = sgm_aggregate(vol, P1, P2)
    disp = torch.argmin(agg, dim=0).to(torch.float32)
    valid = (disp > 0) & (disp < max_disp - 1)
    return disp, valid


def lr_consistency(disp_l, disp_r, max_diff: float = 1.0):
    """Left-right check: disparity consistent when d_L(x) == d_R(x - d)."""
    H, W = disp_l.shape
    x = torch.arange(W, device=disp_l.device)[None, :]
    xr = torch.clamp(x - disp_l.to(torch.int32), 0, W - 1).to(torch.int64)
    dr = torch.gather(disp_r, 1, xr)
    return torch.abs(disp_l - dr) <= max_diff
