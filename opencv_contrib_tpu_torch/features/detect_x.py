"""More xfeatures2d detectors (the port of
opencv_contrib_tpu/features/detect_x.py): the Star (CenSurE-class)
centre-surround detector, MSD (maximal self-dissimilarity), Harris-Laplace,
TBMR-class affine regions as elliptic keypoints, and second-moment affine
adaptation.

Star's box maps are static slices of one edge-padded summed-area table,
built by `ops.integral.integral`, and Harris-Laplace's orientation reads
another, so on a CUDA tensor both launch the integral kernel; so do
Harris-Laplace's Gaussian blurs of sigma >= 3 (`filters.fast_gaussian_blur`).
The JAX version's `_padded_integral` takes the image, the port's
(`features.detect`) takes the table.

`tbmr` labels 32 level sets a frame (16 thresholds, both polarities) with
`ops.ccl`, whose passes read a stop flag once a group (a host sync each),
and keeps every level's moments on the device: the host reads them once, in
one copy, for the selection loop that the JAX version also runs on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from opencv_contrib_tpu_torch.features.detect import _box_map, _padded_integral, _topk_2stage, assign_orientation
from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops import integral as integ
from opencv_contrib_tpu_torch.ops.ccl import connected_components
from opencv_contrib_tpu_torch.ops.image import sample_bilinear_multi
from opencv_contrib_tpu_torch.utils.device import constant
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

_STAR_SIZES = (4, 6, 8, 11, 16, 22, 32)


def _inside(H: int, W: int, m: int, device) -> torch.Tensor:
    """True at least m pixels inside the border."""
    out = torch.zeros(H, W, dtype=torch.bool, device=device)
    out[m:H - m, m:W - m] = True
    return out


def _scale_keypoints(resp: torch.Tensor, scales, max_keypoints: int, scale_mul: float = 1.0) -> Keypoints:
    """The top responses of an (S, H, W) stack as keypoints of scale
    scales[s] * scale_mul."""
    S, H, W = resp.shape
    top_r, top_i = _topk_2stage(resp.reshape(-1), max_keypoints)
    valid = torch.isfinite(top_r)
    zero = torch.zeros_like(top_r)
    sz = constant(scales, resp.device)[top_i // (H * W)]
    pix = top_i % (H * W)
    return Keypoints(y=torch.where(valid, (pix // W).to(torch.float32), zero),
                     x=torch.where(valid, (pix % W).to(torch.float32), zero),
                     scale=torch.where(valid, sz * scale_mul, torch.ones_like(top_r)), angle=zero,
                     response=torch.where(valid, top_r, zero), valid=valid)


def star_detector(img: torch.Tensor, max_keypoints: int = 256, response_threshold: float = 30.0,
                  line_threshold: float = 10.0, sizes: tuple = _STAR_SIZES) -> Keypoints:
    """CenSurE-class centre-surround detector: inner box against its ring at
    each size, 3x3x3 scale-space maxima of |response|, Harris-ratio line
    suppression, top-k; scale = size / 2."""
    H, W = img.shape
    P = _padded_integral(integ.integral(img))

    def cs_response(n):
        inner = _box_map(P, H, W, -n, n + 1, -n, n + 1)
        outer = _box_map(P, H, W, -2 * n, 2 * n + 1, -2 * n, 2 * n + 1)
        a_in = (2 * n + 1) ** 2
        a_out = (4 * n + 1) ** 2 - a_in
        r = inner / a_in - (outer - inner) / a_out
        return torch.where(_inside(H, W, 2 * n + 1, img.device), r, 0.0)

    maps = torch.stack([cs_response(n) for n in sizes])
    amaps = torch.abs(maps)
    neigh = F.max_pool3d(amaps[None, None], 3, stride=1, padding=1)[0, 0]
    is_max = (amaps >= neigh) & (amaps > response_threshold)

    def line_ok(m):
        gy, gx = filters.gradients(m)
        sxx = filters.box_filter(gx * gx, 2)
        syy = filters.box_filter(gy * gy, 2)
        sxy = filters.box_filter(gx * gy, 2)
        tr = sxx + syy
        return tr * tr < line_threshold * torch.clamp(sxx * syy - sxy * sxy, min=1e-12)

    ok_line = torch.stack([line_ok(m) for m in maps])
    resp = torch.where(is_max & ok_line, amaps, -math.inf)
    return _scale_keypoints(resp, sizes, max_keypoints, 0.5)


def msd_detector(img: torch.Tensor, max_keypoints: int = 256, patch_radius: int = 3, search_radius: int = 5,
                 saliency_threshold: float = 0.0) -> Keypoints:
    """MSD: saliency = the least patch SSD against the shifts d with
    patch_radius < |d| <= search_radius (the shifts WRAP, `torch.roll` as
    `jnp.roll`); keypoints at 3x3 maxima of saliency."""
    H, W = img.shape
    sal = torch.full((H, W), math.inf, device=img.device)
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            rr = dy * dy + dx * dx
            if rr <= patch_radius * patch_radius or rr > search_radius * search_radius:
                continue
            diff = img - torch.roll(img, (dy, dx), (0, 1))
            ssd = filters.box_filter(diff * diff, patch_radius) * (2 * patch_radius + 1) ** 2
            sal = torch.minimum(sal, ssd)
    sal = torch.where(_inside(H, W, search_radius + patch_radius + 1, img.device), sal, 0.0)
    neigh = F.max_pool2d(sal[None, None], 3, stride=1, padding=1)[0, 0]
    resp = torch.where((sal >= neigh) & (sal > saliency_threshold), sal, -math.inf)
    kps = _scale_keypoints(resp[None], (float(patch_radius),), max_keypoints)
    return kps._replace(scale=torch.full_like(kps.scale, float(patch_radius)))


def harris_laplace(img: torch.Tensor, max_keypoints: int = 256, n_scales: int = 6, corner_threshold: float = 1e-2,
                   k: float = 0.04) -> Keypoints:
    """Harris corners with automatic scale: spatial 3x3 maxima of the
    scale-normalised Harris measure whose scale-normalised |LoG| peaks
    across the neighbouring scales (sigma_i = 1.5^i), with the SURF Haar
    orientation."""
    sigmas = [1.5 ** i for i in range(n_scales)]
    harris_maps, log_maps = [], []
    for s in sigmas:
        gy, gx = filters.gradients(filters.fast_gaussian_blur(img, 0.7 * s))
        sxx, syy, sxy = (filters.fast_gaussian_blur(m, s) for m in (gx * gx, gy * gy, gx * gy))
        harris_maps.append(((sxx * syy - sxy * sxy) - k * (sxx + syy) ** 2) * s ** 2)
        log_maps.append((s ** 2) * torch.abs(filters.laplacian(filters.fast_gaussian_blur(img, s))))
    Rm = torch.stack(harris_maps)
    Lm = torch.stack(log_maps)
    neigh = F.max_pool2d(Rm[:, None], 3, stride=1, padding=1)[:, 0]
    sp_max = (Rm >= neigh) & (Rm > corner_threshold * torch.clamp(Rm.max(), min=1e-12))
    sc_max = (Lm >= torch.roll(Lm, 1, 0)) & (Lm >= torch.roll(Lm, -1, 0))
    sc_max[0] = False
    sc_max[-1] = False
    resp = torch.where(sp_max & sc_max, Rm, -math.inf)
    kps = _scale_keypoints(resp, sigmas, max_keypoints)
    return assign_orientation(integ.integral(img), kps)


class EllipticKeypoints(NamedTuple):
    """Affine-covariant regions: centre and the ellipse (semi-axes a >= b,
    the major axis' orientation) fitted to the region's moments."""

    y: torch.Tensor  # (K,)
    x: torch.Tensor
    a: torch.Tensor  # major semi-axis
    b: torch.Tensor  # minor semi-axis
    angle: torch.Tensor  # major-axis orientation
    response: torch.Tensor
    valid: torch.Tensor


def _component_moments(labels: torch.Tensor, max_components: int = 64):
    """Per-component raw moments by one float32 one-hot product: (area, cy,
    cx, cyy, cxx, cxy), each (C,). The central second moments are raw
    moments less the squared means, which cancels at VGA (sum y^2 reaches
    about 7e10), so their low bits follow the product's summation order."""
    H, W = labels.shape
    dev = labels.device
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W).reshape(-1)
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W).reshape(-1)
    feats = torch.stack([torch.ones_like(y), y, x, y * y, x * x, y * x], 1)
    oh = F.one_hot(labels.reshape(-1).long(), max_components).to(torch.float32)
    with f32_matmul_precision():
        sums = oh.T @ feats
    area = sums[:, 0]
    az = torch.clamp(area, min=1.0)
    cy, cx = sums[:, 1] / az, sums[:, 2] / az
    return area, cy, cx, sums[:, 3] / az - cy * cy, sums[:, 4] / az - cx * cx, sums[:, 5] / az - cy * cx


def _level_slots(labels: torch.Tensor, maxc: int):
    """The JAX version's `u = jnp.unique(labels, size=maxc, fill_value=-1)`
    and each pixel's index in u, without a host sync: u is -1 first when
    there is background, then the component labels (each its root's raster
    index) in raster order, cut to maxc and filled with -1. A pixel of a
    component cut off takes index 0 (argmax of no match), the background
    index maxc - 1. Returns (slots (H, W), u >= 0)."""
    flat = labels.reshape(-1)
    dev = flat.device
    idx = torch.arange(flat.numel(), dtype=flat.dtype, device=dev)
    is_fg = flat >= 0
    is_root = is_fg & (flat == idx)
    offset = (~is_fg).any().to(torch.int64)  # -1 takes u[0] when there is background
    pos = torch.cumsum(is_root.to(torch.int64), 0) - 1 + offset  # a root's place in u
    target = torch.where(is_root & (pos < maxc), pos, maxc)
    u = torch.full((maxc + 1,), -1, dtype=flat.dtype, device=dev)
    u.scatter_(0, target, torch.where(is_root, idx, -1))  # slot maxc takes the rest and is dropped
    u = u[:maxc]
    root_pos = pos[torch.where(is_fg, flat, 0).long()]
    slot = torch.where(root_pos < maxc, root_pos, 0)
    return torch.where(is_fg, slot, maxc - 1).reshape(labels.shape), u >= 0


def tbmr(img: torch.Tensor, max_regions: int = 64, n_levels: int = 16, min_area: int = 30,
         max_area_frac: float = 0.2) -> EllipticKeypoints:
    """TBMR-class affine regions: components of the level sets of both
    polarities at n_levels thresholds, each fitted with its moment ellipse;
    the largest first, one of any two with near centres and areas dropped,
    up to max_regions."""
    img = img.to(torch.float32)
    H, W = img.shape
    maxc = max_regions
    lo, hi = (float(v) for v in torch.stack([img.min(), img.max()]).tolist())
    ths = np.linspace(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), n_levels).astype(np.float32)
    levels = []
    for t in ths:
        for mask in (img <= float(t), img >= float(t)):
            labels, _ = connected_components(mask, connectivity=4)
            comp, okc = _level_slots(labels, maxc)
            levels.append(torch.stack([*_component_moments(comp, maxc), okc.to(torch.float32)]))
    host = torch.stack(levels).cpu().numpy()  # (2 n_levels, 7, maxc): one copy
    recs = []
    for area, cy, cx, cyy, cxx, cxy, okc in host:
        ok = (okc > 0) & (area >= min_area) & (area <= max_area_frac * H * W)
        for i in np.where(ok)[0]:
            recs.append((float(area[i]), float(cy[i]), float(cx[i]), float(cyy[i]), float(cxx[i]), float(cxy[i])))
    recs.sort(key=lambda r: -r[0])
    kept = []
    for r in recs:
        if len(kept) >= max_regions:
            break
        if all((r[1] - k[1]) ** 2 + (r[2] - k[2]) ** 2 > 16 or abs(r[0] - k[0]) > 0.3 * k[0] for k in kept):
            kept.append(r)
    out = np.zeros((max_regions, 7), np.float32)
    for i, (ar, cy, cx, cyy, cxx, cxy) in enumerate(kept):
        evals, evecs = np.linalg.eigh(np.array([[cxx, cxy], [cxy, cyy]]))
        a = 2.0 * np.sqrt(max(evals[1], 1e-6))
        b = 2.0 * np.sqrt(max(evals[0], 1e-6))
        out[i] = (cy, cx, a, b, np.arctan2(evecs[1, 1], evecs[0, 1]), ar, 1.0)
    o = torch.from_numpy(out).to(img.device)
    return EllipticKeypoints(y=o[:, 0], x=o[:, 1], a=o[:, 2], b=o[:, 3], angle=o[:, 4], response=o[:, 5],
                             valid=o[:, 6] > 0)


def affine_adapt(img: torch.Tensor, kps: Keypoints, n_samples: int = 16) -> EllipticKeypoints:
    """Second-moment affine adaptation: the gradient second-moment matrix in
    a Gaussian window at each keypoint's scale; the ellipse is its inverse
    square root, normalised so that sqrt(a b) = scale."""
    gy, gx = filters.gradients(filters.gaussian_blur(img, 1.0))
    n = n_samples
    u = (torch.arange(n, dtype=torch.float32, device=img.device) - n / 2 + 0.5) * (6.0 / n)
    gyy, gxx = torch.meshgrid(u, u, indexing="ij")
    w = torch.exp(-(gxx ** 2 + gyy ** 2) / 2.0).reshape(-1)
    px = kps.x[:, None] + kps.scale[:, None] * gxx.reshape(-1)[None]
    py = kps.y[:, None] + kps.scale[:, None] * gyy.reshape(-1)[None]
    sgx, sgy = sample_bilinear_multi(torch.stack([gx, gy]), py, px)
    sxx = (w[None] * sgx * sgx).sum(-1)
    syy = (w[None] * sgy * sgy).sum(-1)
    sxy = (w[None] * sgx * sgy).sum(-1)
    tr = sxx + syy
    det = torch.clamp(sxx * syy - sxy * sxy, min=1e-12)
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    l1 = tr / 2 + disc
    l2 = torch.clamp(tr / 2 - disc, min=1e-12)
    a_r = 1.0 / torch.sqrt(l2)
    b_r = 1.0 / torch.sqrt(l1)
    s = kps.scale / torch.sqrt(a_r * b_r)
    ang = 0.5 * torch.atan2(2 * sxy, sxx - syy) + math.pi / 2
    return EllipticKeypoints(y=kps.y, x=kps.x, a=a_r * s, b=b_r * s, angle=ang, response=kps.response,
                             valid=kps.valid)
