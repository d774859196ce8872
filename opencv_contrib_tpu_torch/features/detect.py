"""Fast-Hessian (SURF-class) detector with Haar orientation — the port of
opencv_contrib_tpu/features/detect.py::fast_hessian.

All layers' box responses are static slices of one edge-padded integral
image; the 3x3x3 scale-space NMS is `max_pool3d` (its padding is -inf);
selection is the two-stage top-k of the JAX version, with ties to the lower
index as `jax.lax.top_k`/`argmax` give them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.ops import integral as integ
from opencv_contrib_tpu_torch.ops.image import sample_bilinear_multi

_II_PAD = 64  # supports filter sizes up to ~3*42


def _padded_integral(ii: torch.Tensor) -> torch.Tensor:
    """Edge-padded integral image for static-slice box sums."""
    return F.pad(ii[None, None], (_II_PAD,) * 4, mode="replicate")[0, 0]


def _box_map(P: torch.Tensor, H: int, W: int, a: int, b: int, c: int, d: int) -> torch.Tensor:
    """Dense box sums over rows [y+a, y+b) and cols [x+c, x+d) for every
    pixel: four static slices of the padded integral image."""
    p = _II_PAD

    def S(dy, dx):
        return P[p + dy:p + dy + H, p + dx:p + dx + W]

    return S(b, d) - S(a, d) - S(b, c) + S(a, c)


def _hessian_response(P: torch.Tensor, H: int, W: int, size: int) -> torch.Tensor:
    """Fast-Hessian determinant map for one filter size (SURF 9x9-base box
    layout); -inf where the filter hangs off the image."""
    s = size // 3  # lobe width
    norm = 1.0 / (size * size)
    w2 = 2 * s - 1
    hw = w2 // 2

    y0 = -(3 * s) // 2
    atop = _box_map(P, H, W, y0, y0 + s, -hw, -hw + w2)
    amid = _box_map(P, H, W, y0 + s, y0 + 2 * s, -hw, -hw + w2)
    abot = _box_map(P, H, W, y0 + 2 * s, y0 + 3 * s, -hw, -hw + w2)
    dyy = (atop - 2.0 * amid + abot) * norm

    x0 = -(3 * s) // 2
    aL = _box_map(P, H, W, -hw, -hw + w2, x0, x0 + s)
    aM = _box_map(P, H, W, -hw, -hw + w2, x0 + s, x0 + 2 * s)
    aR = _box_map(P, H, W, -hw, -hw + w2, x0 + 2 * s, x0 + 3 * s)
    dxx = (aL - 2.0 * aM + aR) * norm

    tl = _box_map(P, H, W, -s, 0, -s, 0)
    tr = _box_map(P, H, W, -s, 0, 1, 1 + s)
    bl = _box_map(P, H, W, 1, 1 + s, -s, 0)
    br = _box_map(P, H, W, 1, 1 + s, 1, 1 + s)
    dxy = (tl - tr - bl + br) * norm

    det = dxx * dyy - (0.81 * dxy * dxy)
    margin = (3 * s) // 2 + 1
    out = torch.full_like(det, -math.inf)
    if H > 2 * margin and W > 2 * margin:
        out[margin:H - margin, margin:W - margin] = det[margin:H - margin, margin:W - margin]
    return out


def _topk_2stage(flat: torch.Tensor, k: int, n_rows: int = 4096):
    """Hierarchical top-k: per-row top-2 over n_rows contiguous chunks, then
    an exact top-k over the 2*n_rows candidates (at most 2 winners per chunk).
    Ties go to the lower index at both stages."""
    n = flat.shape[0]
    m = -(-n // n_rows)
    pad = n_rows * m - n
    fl = F.pad(flat, (0, pad), value=-math.inf).reshape(n_rows, m)
    a1 = torch.argmax(fl, dim=1)
    v1 = torch.gather(fl, 1, a1[:, None])[:, 0]
    fl2 = fl.scatter(1, a1[:, None], -math.inf)
    a2 = torch.argmax(fl2, dim=1)
    v2 = torch.gather(fl2, 1, a2[:, None])[:, 0]
    row0 = torch.arange(n_rows, device=flat.device) * m
    cand_v = torch.cat([v1, v2])
    cand_i = torch.cat([row0 + a1, row0 + a2])
    top_v, sel = torch.sort(cand_v, descending=True, stable=True)
    return top_v[:k], cand_i[sel[:k]]


def surf_filter_sizes(n_octaves: int = 3, n_layers: int = 4):
    """SURF filter-size ladder: 9,15,21,27 / 15,27,39,51 / 27,51,75,99."""
    sizes = []
    for o in range(n_octaves):
        step = 6 * (1 << o)
        first = 9 * (1 << o) - 6 * ((1 << o) - 1)
        sizes.append(tuple(first + step * l for l in range(n_layers)))
    return tuple(sizes)


def _roll_diffs(mf: torch.Tensor, dim: int):
    up, dn = torch.roll(mf, -1, dim), torch.roll(mf, 1, dim)
    return (up - dn) * 0.5, up - 2 * mf + dn


def _offset(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    big = torch.abs(h) > 1e-6
    off = torch.where(big, -g / torch.where(big, h, torch.ones_like(h)), torch.zeros_like(g))
    return torch.clamp(off, -0.5, 0.5)


def fast_hessian(
    img: torch.Tensor,
    max_keypoints: int = 512,
    threshold: float = 100.0,
    n_octaves: int = 3,
    n_layers: int = 4,
) -> Keypoints:
    """SURF-class detector: top-k scale-space Hessian maxima with subpixel
    and subscale interpolation. img: (H, W) float grayscale on 0..255."""
    H, W = img.shape
    dev = img.device
    ii = integ.integral(img)  # for the orientation stage and the box maps
    P = _padded_integral(ii)
    ladders = surf_filter_sizes(n_octaves, n_layers)

    all_y, all_x, all_s, all_r = [], [], [], []
    for sizes in ladders:
        maps = torch.stack([_hessian_response(P, H, W, sz) for sz in sizes])  # (L, H, W)
        neigh = F.max_pool3d(maps[None, None], 3, stride=1, padding=1)[0, 0]
        is_max = (maps >= neigh) & (maps > threshold)
        is_max[0] = False
        is_max[-1] = False

        # quadratic interpolation along (layer, y, x) on a finite clamp
        mf = torch.clamp(maps, min=0.0)
        d_l, d_ll = _roll_diffs(mf, 0)
        d_y, d_yy = _roll_diffs(mf, 1)
        d_x, d_xx = _roll_diffs(mf, 2)
        off_l, off_y, off_x = _offset(d_l, d_ll), _offset(d_y, d_yy), _offset(d_x, d_xx)

        resp = torch.where(is_max, maps, torch.full_like(maps, -math.inf))
        sizes_f = torch.tensor(sizes, dtype=torch.float32, device=dev)
        step_f = sizes_f[1] - sizes_f[0]
        L = len(sizes)
        ll = torch.arange(L, dtype=torch.float32, device=dev)[:, None, None]
        ly = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
        lx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
        size_interp = sizes_f[0] + (ll + off_l) * step_f
        sc = 1.2 * size_interp / 9.0  # SURF scale: sigma = 1.2 * size / 9

        all_y.append((ly + off_y).reshape(-1))
        all_x.append((lx + off_x).reshape(-1))
        all_s.append(sc.reshape(-1))
        all_r.append(resp.reshape(-1))

    ys, xs, ss, rs = (torch.cat(a) for a in (all_y, all_x, all_s, all_r))
    top_r, top_i = _topk_2stage(rs, max_keypoints)
    valid = torch.isfinite(top_r)
    zero = torch.zeros_like(top_r)
    kps = Keypoints(
        y=torch.where(valid, ys[top_i], zero),
        x=torch.where(valid, xs[top_i], zero),
        scale=torch.where(valid, ss[top_i], torch.ones_like(top_r)),
        angle=torch.zeros_like(top_r),
        response=torch.where(valid, top_r, zero),
        valid=valid,
    )
    return assign_orientation(ii, kps)


def _haar_maps(ii: torch.Tensor, sizes=(2, 4, 8, 16)) -> torch.Tensor:
    """Dense haar_x / haar_y maps for a few wavelet sizes from the integral
    image (clamped shifts), stacked (2S, H, W)."""
    Hp, Wp = ii.shape
    H, W = Hp - 1, Wp - 1
    ar_y = torch.arange(H, device=ii.device)
    ar_x = torch.arange(W, device=ii.device)

    def shifted(dy, dx):
        y0 = torch.clamp(ar_y + dy, 0, Hp - 1)
        x0 = torch.clamp(ar_x + dx, 0, Wp - 1)
        return ii[y0][:, x0]

    def box(dy0, dx0, hh, ww):
        return (shifted(dy0 + hh, dx0 + ww) - shifted(dy0, dx0 + ww)
                - shifted(dy0 + hh, dx0) + shifted(dy0, dx0))

    maps = []
    for w in sizes:
        h = w // 2
        left = box(-h, -h, w, h)
        right = box(-h, 0, w, h)
        top = box(-h, -h, h, w)
        bot = box(0, -h, h, w)
        maps.append(right - left)  # haar_x at this size
        maps.append(bot - top)  # haar_y
    return torch.stack(maps)


def _orientation_offsets(device):
    offs = [(dy, dx, math.exp(-(dy * dy + dx * dx) / (2 * 3.3 ** 2)))
            for dy in range(-5, 6) for dx in range(-5, 6) if dy * dy + dx * dx <= 25]
    t = torch.tensor(offs, dtype=torch.float32, device=device)
    return t[:, 0], t[:, 1], t[:, 2]


def assign_orientation(ii: torch.Tensor, kps: Keypoints, n_bins: int = 36) -> Keypoints:
    """Dominant orientation from Haar responses in a radius-6s disc: an
    angular histogram with parabolic peak refinement. Wavelet sizes are
    quantized to 4 dense maps sampled with one corner-stacked gather."""
    sizes = (2, 4, 8, 16)
    maps = _haar_maps(ii, sizes)  # (8, H, W)
    offs_y, offs_x, offs_w = _orientation_offsets(ii.device)

    s = torch.clamp(kps.scale, min=1.0)
    want = 2.0 * s
    size_idx = torch.clamp(torch.round(torch.log2(torch.clamp(want, min=2.0))) - 1,
                           0, len(sizes) - 1).to(torch.int64)

    py = kps.y[:, None] + offs_y[None, :] * s[:, None]  # (K, M)
    px = kps.x[:, None] + offs_x[None, :] * s[:, None]
    K, M = py.shape
    samples = sample_bilinear_multi(maps, py, px)  # (8, K, M)
    sam = torch.movedim(samples, 0, -1).reshape(K, M, len(sizes), 2)
    sel = torch.gather(sam, 2, size_idx[:, None, None, None].expand(K, M, 1, 2))[:, :, 0]
    dx = sel[..., 0] * offs_w[None, :]
    dy = sel[..., 1] * offs_w[None, :]

    ang = torch.atan2(dy, dx)
    mag = torch.sqrt(dx * dx + dy * dy)
    bin_f = (ang + math.pi) / (2 * math.pi) * n_bins
    bin_i = torch.clamp(bin_f.to(torch.int64), 0, n_bins - 1)
    if mag.is_cuda:  # scatter_add_'s float atomics sum in an order that changes from run to run
        onehot = bin_i[..., None] == torch.arange(n_bins, device=mag.device)
        hist = torch.sum(torch.where(onehot, mag[..., None], torch.zeros_like(mag)[..., None]), dim=1)
    else:  # in index order, as the JAX package's scatter-add sums on the CPU
        hist = torch.zeros(K, n_bins, dtype=mag.dtype, device=mag.device).scatter_add_(1, bin_i, mag)
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1)
    l = torch.gather(hist, 1, ((peak - 1) % n_bins)[:, None])[:, 0]
    c = torch.gather(hist, 1, peak[:, None])[:, 0]
    r = torch.gather(hist, 1, ((peak + 1) % n_bins)[:, None])[:, 0]
    denom = l - 2 * c + r
    big = torch.abs(denom) > 1e-9
    delta = torch.where(big, 0.5 * (l - r) / torch.where(big, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
    angle = ((peak + 0.5 + delta) / n_bins) * 2 * math.pi - math.pi
    return kps._replace(angle=torch.where(kps.valid, angle, torch.zeros_like(angle)))
