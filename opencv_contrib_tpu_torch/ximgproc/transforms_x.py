"""ximgproc transforms and detectors, part 2 (the port of
opencv_contrib_tpu/ximgproc/transforms_x.py): the Radon transform, Pei-Lin
normalization, quaternion colour matching, region covariance, fast
large-window erode / dilate, ScanSegment superpixels and ellipse detection.

Where the port differs in mechanism, the result is kept:
- `find_ellipses` takes its components by a stable descending sort of the
  integer edge counts, so equal counts keep the lower label first, as
  `lax.top_k` does (`torch.topk` promises no order among ties); the counts
  are integer scatters, exact in any order;
- ScanSegment's centres are `ops.segment.segment_sum`s, which give the same
  bits on a rerun on the card;
- the 3 x 3 determinants and inverses of the ellipse fit are cofactor
  formulas and the 2 x 2 symmetric eigenproblems closed forms, batched over
  the components with no host sync (`torch.linalg` checks its solvers' info
  on the host); an eigenvector's sign is free in both versions, so an
  ellipse's angle is defined up to pi."""

from __future__ import annotations

import math

import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import warp_affine
from opencv_contrib_tpu_torch.ops.segment import segment_count, segment_sum
from opencv_contrib_tpu_torch.utils.device import constant
from opencv_contrib_tpu_torch.utils.precision import f32_matmuls
from opencv_contrib_tpu_torch.ximgproc.edges import _linspace


# ---------------------------------------------------------------------------
# Radon transform
# ---------------------------------------------------------------------------


def radon_transform(img: torch.Tensor, n_angles: int = 180, start_deg: float = 0.0,
                    end_deg: float = 180.0) -> torch.Tensor:
    """Radon transform (parity: cv::ximgproc::RadonTransform,
    radon_transform.cpp): projections of the image onto lines at n_angles
    orientations: each a bilinear rotation (`warp_affine`) of the image
    centred on a diag x diag canvas, summed over its rows.

    Returns (n_angles, diag) sinogram."""
    img = img.to(torch.float32)
    H, W = img.shape
    dev = img.device
    diag = int(math.ceil(math.sqrt(H * H + W * W)))
    py0 = (diag - H) // 2
    px0 = (diag - W) // 2
    canvas = torch.zeros((diag, diag), dtype=img.dtype, device=dev)
    canvas[py0:py0 + H, px0:px0 + W] = img
    thetas = torch.deg2rad(_linspace(start_deg, end_deg, n_angles, endpoint=False, device=dev))
    c = (diag - 1) / 2.0
    ct, st = torch.cos(thetas), torch.sin(thetas)
    # rotate by -theta about the centre: A maps output coords -> input coords
    A = torch.stack([torch.stack([ct, -st, c - ct * c + st * c], -1),
                     torch.stack([st, ct, c - st * c - ct * c], -1)], 1)  # (n_angles, 2, 3)
    return torch.stack([warp_affine(canvas, A[i], (diag, diag)).sum(dim=0) for i in range(n_angles)])


# ---------------------------------------------------------------------------
# Pei-Lin normalization
# ---------------------------------------------------------------------------


def _eigh2(a, b, c):
    """Eigen-decomposition of the symmetric 2 x 2 [[a, b], [b, c]] (each a
    tensor of one shape), eigenvalues ascending: returns (l0, l1, v0, v1),
    v0 / v1 (..., 2) unit eigenvectors (column 0 / 1 of eigh's matrix)."""
    half_tr = 0.5 * (a + c)
    d = torch.sqrt(0.25 * (a - c) ** 2 + b * b)
    l0, l1 = half_tr - d, half_tr + d
    # the eigenvector of l1 from whichever row of A - l1 I is larger
    r1 = torch.stack([b, l1 - a], -1)
    r2 = torch.stack([l1 - c, b], -1)
    n1, n2 = torch.linalg.vector_norm(r1, dim=-1), torch.linalg.vector_norm(r2, dim=-1)
    v1 = torch.where((n1 >= n2)[..., None], r1 / torch.clamp(n1, min=1e-30)[..., None],
                     r2 / torch.clamp(n2, min=1e-30)[..., None])
    degenerate = (torch.maximum(n1, n2) <= 0)[..., None]
    e1 = torch.stack([torch.zeros_like(a), torch.ones_like(a)], -1)
    v1 = torch.where(degenerate, e1, v1)
    v0 = torch.stack([v1[..., 1], -v1[..., 0]], -1)
    return l0, l1, v0, v1


def peilin_normalization(img: torch.Tensor) -> torch.Tensor:
    """Pei-Lin image normalization (parity: cv::ximgproc::PeiLinNormalization,
    peilin.cpp): the affine transform W = sR(theta) Lambda^{-1/2} R(-phi)
    built from second/third central moments, making the image invariant to
    affine distortion. Returns the 2x3 matrix (output->input convention
    matching ops.image.warp_affine)."""
    f = img.to(torch.float32)
    H, W = f.shape
    dev = f.device
    ys = torch.arange(H, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, device=dev)[None, :].expand(H, W)
    m00 = f.sum() + 1e-9
    xc = (f * xs).sum() / m00
    yc = (f * ys).sum() / m00
    dx = xs - xc
    dy = ys - yc
    mu20 = (f * dx * dx).sum() / m00
    mu02 = (f * dy * dy).sum() / m00
    mu11 = (f * dx * dy).sum() / m00
    l0, l1, v0, v1 = _eigh2(mu20, mu11, mu02)
    evals = torch.clamp(torch.stack([l0, l1]), min=1e-9)
    evecs = torch.stack([v0, v1], 1)  # columns
    scale = torch.sqrt(torch.sqrt(evals[0] * evals[1]))
    Wm = evecs @ torch.diag(scale / torch.sqrt(evals)) @ evecs.T
    wdx = Wm[0, 0] * dx + Wm[0, 1] * dy
    wdy = Wm[1, 0] * dx + Wm[1, 1] * dy
    mu30 = (f * wdx ** 3).sum() / m00
    mu12 = (f * wdx * wdy ** 2).sum() / m00
    mu21 = (f * wdx ** 2 * wdy).sum() / m00
    mu03 = (f * wdy ** 3).sum() / m00
    theta = torch.atan2(mu03 + mu21, mu30 + mu12)
    ct, st = torch.cos(theta), torch.sin(theta)
    R = torch.stack([torch.stack([ct, st]), torch.stack([-st, ct])])
    M = R @ Wm
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    Minv = torch.stack([torch.stack([M[1, 1], -M[0, 1]]), torch.stack([-M[1, 0], M[0, 0]])]) / det
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    t = torch.stack([xc - (Minv[0, 0] * cx + Minv[0, 1] * cy), yc - (Minv[1, 0] * cx + Minv[1, 1] * cy)])
    return torch.cat([Minv, t[:, None]], dim=1)


# ---------------------------------------------------------------------------
# Quaternion color matching
# ---------------------------------------------------------------------------


def color_match_template(img_rgb: torch.Tensor, templ_rgb: torch.Tensor) -> torch.Tensor:
    """Quaternion cross-correlation of a color template (parity:
    cv::ximgproc::colorMatchTemplate, color_match.cpp): RGB pixels as pure
    quaternions (0, r, g, b); the correlation magnitude peaks where the
    template's full color structure matches. The 4 quaternion component
    correlations by FFTs."""
    H, W = img_rgb.shape[:2]
    h, w = templ_rgb.shape[:2]
    img = img_rgb.to(torch.float32)
    tpl = templ_rgb.to(torch.float32)
    tnorm = tpl - tpl.mean(dim=(0, 1), keepdim=True)
    inorm = img - img.mean(dim=(0, 1), keepdim=True)
    pad = torch.zeros((H, W, 3), dtype=torch.float32, device=img.device)
    pad[:h, :w] = tnorm
    Fi = torch.fft.fft2(inorm, dim=(0, 1))
    Ft = torch.fft.fft2(pad, dim=(0, 1))
    cFt = torch.conj(Ft)
    scalar = torch.real(torch.fft.ifft2((Fi * cFt).sum(-1), dim=(0, 1)))
    mag2 = scalar ** 2
    for i, j in ((1, 2), (2, 0), (0, 1)):
        Cij = torch.real(torch.fft.ifft2(Fi[..., i] * cFt[..., j] - Fi[..., j] * cFt[..., i], dim=(0, 1)))
        mag2 = mag2 + Cij ** 2
    return torch.sqrt(mag2) / torch.clamp((tnorm ** 2).sum(), min=1e-9)


# ---------------------------------------------------------------------------
# Region covariance estimation
# ---------------------------------------------------------------------------


def covariance_estimation(img: torch.Tensor, window: int = 7) -> torch.Tensor:
    """Windowed covariance of the (I, Ix, Iy, x, y) feature vector (parity:
    cv::ximgproc::covarianceEstimation, estimated_covariance.cpp). Returns
    (H, W, d, d) covariance fields via box sums of feature products."""
    f = img.to(torch.float32)
    gy, gx = filters.gradients(f)
    H, W = f.shape
    ys = torch.arange(H, device=f.device, dtype=torch.float32)[:, None].expand(H, W)
    xs = torch.arange(W, device=f.device, dtype=torch.float32)[None, :].expand(H, W)
    feats = [f, gx, gy, xs / W, ys / H]
    r = window // 2
    d = len(feats)
    means = [filters.box_filter(feats[i], r) for i in range(d)]
    cov = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i, d):
            cij = filters.box_filter(feats[i] * feats[j], r) - means[i] * means[j]
            cov[i][j] = cov[j][i] = cij
    return torch.stack([torch.stack(row, -1) for row in cov], -2)


# ---------------------------------------------------------------------------
# Fast large-SE morphology (run-length module's role)
# ---------------------------------------------------------------------------


def _extreme_1d(x, radius: int, op):
    """Separable running min/max of total width 2*radius+1 by log-doubling
    shifted copies: O(log r) whole-image ops (the role of run-length-encoded
    morphology, run_length_morphology.cpp)."""
    left = x
    right = x
    covered = 0
    step = 1
    while covered < radius:
        take = min(step, radius - covered)
        left = op(left, torch.roll(left, take, 1))
        right = op(right, torch.roll(right, -take, 1))
        covered += take
        step = take * 2
    return op(left, right)


def _morph2d(img, radius_y: int, radius_x: int, op, pad_val):
    H, W = img.shape
    x = torch.nn.functional.pad(img.to(torch.float32), (radius_x, radius_x, radius_y, radius_y), value=pad_val)
    x = _extreme_1d(x, radius_x, op)
    x = _extreme_1d(x.T, radius_y, op).T
    return x[radius_y:radius_y + H, radius_x:radius_x + W]


def erode_fast(img: torch.Tensor, radius_y: int = 5, radius_x: int = 5) -> torch.Tensor:
    """Large-SE erosion in O(log r) passes (role of run_length_morphology's
    rl::erode for big rectangular structuring elements)."""
    return _morph2d(img, radius_y, radius_x, torch.minimum, math.inf)


def dilate_fast(img: torch.Tensor, radius_y: int = 5, radius_x: int = 5) -> torch.Tensor:
    """Large-SE dilation in O(log r) passes (role of rl::dilate)."""
    return _morph2d(img, radius_y, radius_x, torch.maximum, -math.inf)


# ---------------------------------------------------------------------------
# ScanSegment superpixels
# ---------------------------------------------------------------------------


def scan_segment(img: torch.Tensor, n_superpixels: int = 256, n_iters: int = 4) -> torch.Tensor:
    """ScanSegment-class superpixels (parity: cv::ximgproc::ScanSegment,
    scansegment.cpp): grid-seeded local color clustering; every iteration
    is one dense assign step against the 9 neighbouring seed candidates and
    one mean update (a segment sum)."""
    H, W = img.shape[:2]
    f = img.to(torch.float32)
    if f.ndim == 2:
        f = f[..., None]
    dev = f.device
    gh = int(max(1, round((n_superpixels * H / W) ** 0.5)))
    gw = int(max(1, round(n_superpixels / gh)))
    K = gh * gw
    ys = torch.arange(H, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, device=dev)[None, :].expand(H, W)
    cell_y = torch.clamp(torch.div(ys * gh, H, rounding_mode="floor"), 0, gh - 1)
    cell_x = torch.clamp(torch.div(xs * gw, W, rounding_mode="floor"), 0, gw - 1)
    labels = (cell_y * gw + cell_x).to(torch.int64)

    S = max(H / gh, W / gw)
    coord = torch.stack([ys.to(torch.float32) / S, xs.to(torch.float32) / S], -1)
    feat = torch.cat([f * 4.0, coord], dim=-1)  # color weight ~ scansegment
    D = feat.shape[-1]
    flat_feat = feat.reshape(-1, D)
    for _ in range(n_iters):
        sums = segment_sum(labels.reshape(-1), flat_feat, K)
        counts = segment_count(labels.reshape(-1), K)
        cent = sums / torch.clamp(counts[:, None], min=1.0)
        best_d = torch.full((H, W), float("inf"), device=dev)
        best_l = labels
        ly, lx = torch.div(labels, gw, rounding_mode="floor"), torch.remainder(labels, gw)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                cand = torch.clamp(ly + dy, 0, gh - 1) * gw + torch.clamp(lx + dx, 0, gw - 1)
                d = ((feat - cent[cand]) ** 2).sum(-1)
                take = d < best_d
                best_d = torch.where(take, d, best_d)
                best_l = torch.where(take, cand, best_l)
        labels = best_l
    return labels.to(torch.int32)


# ---------------------------------------------------------------------------
# Ellipse detection
# ---------------------------------------------------------------------------


def _det3(M):
    """Determinant of (..., 3, 3) by cofactors along the first row."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _inv3(M):
    """Inverse of (..., 3, 3): the adjugate over the determinant."""
    rows = []
    for i in range(3):
        row = []
        for j in range(3):
            # cofactor C_ji (the transpose of the cofactor matrix)
            r = [k for k in range(3) if k != j]
            c = [k for k in range(3) if k != i]
            minor = M[..., r[0], c[0]] * M[..., r[1], c[1]] - M[..., r[0], c[1]] * M[..., r[1], c[0]]
            row.append(minor if (i + j) % 2 == 0 else -minor)
        rows.append(torch.stack(row, -1))
    return torch.stack(rows, -2) / _det3(M)[..., None, None]


def _eig3_cardano(M):
    """The real eigenvalues of real 3x3 matrices (..., 3, 3) via the
    characteristic cubic, in real arithmetic. Returns (roots (..., 3),
    is_real (..., 3) bool): with a positive discriminant the single real
    root is replicated."""
    c2 = M.diagonal(dim1=-2, dim2=-1).sum(-1)
    c1 = 0.5 * (c2 * c2 - (M @ M).diagonal(dim1=-2, dim2=-1).sum(-1))
    c0 = _det3(M)
    a, b, c = -c2, c1, -c0
    p = b - a * a / 3.0
    q = 2.0 * a ** 3 / 27.0 - a * b / 3.0 + c
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    def cbrt(x):
        return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)

    s = torch.sqrt(torch.clamp(disc, min=0.0))
    t_single = cbrt(-q / 2.0 + s) + cbrt(-q / 2.0 - s)
    p_neg = torch.clamp(p, max=-1e-12)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    ks = torch.arange(3, dtype=torch.float32, device=M.device)
    t_triple = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * ks / 3.0)
    three_real = (disc <= 0)[..., None]
    roots = torch.where(three_real, t_triple, t_single[..., None]) - (a / 3.0)[..., None]
    one_real = torch.arange(3, device=M.device) == 0
    is_real = torch.where(three_real, torch.ones_like(one_real), one_real)
    return roots, is_real


def _fit_ellipse_direct(pts, w):
    """Fitzgibbon/Halir-Flusser direct least-squares ellipse fit on weighted
    points (N, 2) with validity weights (B, N), for B components at once.
    Returns conic coefficients (B, 6) (a, b, c, d, e, f) for
    ax^2+bxy+cy^2+dx+ey+f=0; the ellipse-constrained eigenvector of the
    reduced 3x3 system from an analytic cubic eigensolve + adjugate null
    vectors."""
    x = pts[..., 0]
    y = pts[..., 1]
    D1 = torch.stack([x * x, x * y, y * y], -1) * w[..., None]  # (B, N, 3)
    D2 = torch.stack([x, y, torch.ones_like(x)], -1) * w[..., None]
    S1 = D1.transpose(-1, -2) @ D1
    S2 = D1.transpose(-1, -2) @ D2
    S3 = D2.transpose(-1, -2) @ D2
    eye = torch.eye(3, device=pts.device)
    S3i = _inv3(S3 + 1e-9 * eye)
    T = -S3i @ S2.transpose(-1, -2)
    M = S1 + S2 @ T
    C1i = constant([[0.0, 0.0, 0.5], [0.0, -1.0, 0.0], [0.5, 0.0, 0.0]], pts.device)
    My = C1i @ M

    lams, is_real = _eig3_cardano(My)  # (B, 3)
    A = My[:, None] - lams[..., None, None] * eye  # (B, 3, 3, 3): one matrix a root
    cands = torch.stack([torch.linalg.cross(A[..., 0, :], A[..., 1, :]), torch.linalg.cross(A[..., 1, :], A[..., 2, :]),
                         torch.linalg.cross(A[..., 0, :], A[..., 2, :])], -2)  # (B, 3, 3 cands, 3)
    norms = torch.linalg.vector_norm(cands, dim=-1)
    v = torch.gather(cands, -2, torch.argmax(norms, -1)[..., None, None].expand(*norms.shape[:-1], 1, 3))[..., 0, :]
    vecs = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)  # (B, 3, 3)
    cond = 4.0 * vecs[..., 0] * vecs[..., 2] - vecs[..., 1] ** 2
    ok = is_real & (cond > 1e-9)
    pick = torch.argmax(ok.to(torch.float32) - 1e-6 * torch.abs(lams), -1)
    a1 = torch.gather(vecs, 1, pick[:, None, None].expand(-1, 1, 3))[:, 0]
    a2 = (T @ a1[..., None])[..., 0]
    return torch.cat([a1, a2], -1)


def conic_to_ellipse(coef):
    """Conic (a,b,c,d,e,f) -> (cx, cy, major, minor, angle); coef (6,) or
    (B, 6). The angle is the major axis's direction, defined up to pi."""
    a, b, c, d, e, f = coef.unbind(-1)
    den = 4 * a * c - b * b
    cx = (b * e - 2 * c * d) / torch.clamp(den, min=1e-12)
    cy = (b * d - 2 * a * e) / torch.clamp(den, min=1e-12)
    mu = a * cx * cx + b * cx * cy + c * cy * cy + d * cx + e * cy + f
    s = torch.clamp(-mu, min=1e-12)
    l0, l1, v0, _ = _eigh2(a / s, (b / 2) / s, c / s)
    axes0 = 1.0 / torch.sqrt(torch.clamp(l0, min=1e-12))  # evals ascending -> axes descending
    axes1 = 1.0 / torch.sqrt(torch.clamp(l1, min=1e-12))
    angle = torch.atan2(v0[..., 1], v0[..., 0])
    return torch.stack([cx, cy, axes0, axes1, angle], -1)


@f32_matmuls
def find_ellipses(img: torch.Tensor, max_ellipses: int = 8, canny_lo: float = 0.04, canny_hi: float = 0.12,
                  min_pts: int = 30, score_thresh: float = 0.5):
    """Ellipse detection (parity: cv::ximgproc::findEllipses,
    find_ellipses.cpp): Canny edges -> connected components -> per-component
    direct ellipse fit (all at once) -> score by on-conic inlier fraction.
    Returns (ellipses (max_ellipses, 5), scores (max_ellipses,)); rows with
    score 0 are padding."""
    from opencv_contrib_tpu_torch.ops.ccl import connected_components
    from opencv_contrib_tpu_torch.ximgproc.hough_mser import canny

    img = img.to(torch.float32)
    edges = canny(img, canny_lo, canny_hi)
    edge_mask = edges > 0
    # bridge 1-px NMS gaps so contours label as single components; the fit
    # still uses only true edge pixels
    grown = edge_mask
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grown = grown | torch.roll(edge_mask, (dy, dx), (0, 1))
    labels, _ = connected_components(grown)
    H, W = img.shape
    dev = img.device
    flat_e = edge_mask.reshape(-1)
    flat_l = labels.reshape(-1).to(torch.int64)
    flat_l = torch.where((flat_l < 0) | (flat_l >= H * W) | ~flat_e, H * W, flat_l)
    # top components by edge-pixel count (slot H*W collects background)
    # the background slot H*W (the JAX version zeroes it) sorts after every
    # label of the same count, so dropping it keeps the order
    counts = segment_count(flat_l, H * W + 1)[:H * W]
    top = torch.sort(counts, descending=True, stable=True).indices[:max_ellipses]

    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W).reshape(-1)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W).reshape(-1)
    pts_all = torch.stack([xs, ys], 1)  # (N, 2)
    w = (flat_l[None, :] == top[:, None]).to(torch.float32)  # (B, N)
    n = w.sum(1)
    mean = (w @ pts_all) / torch.clamp(n, min=1.0)[:, None]  # (B, 2)
    diff = pts_all[None] - mean[:, None]
    scale = torch.sqrt(((diff ** 2) * w[..., None]).sum((1, 2)) / torch.clamp(n, min=1.0)) + 1e-6
    pn = diff / scale[:, None, None]
    ell = conic_to_ellipse(_fit_ellipse_direct(pn, w))
    ell = torch.cat([ell[:, 0:2] * scale[:, None] + mean, ell[:, 2:4] * scale[:, None], ell[:, 4:]], 1)
    cx, cy, a_maj, a_min, th = ell.unbind(1)
    ct, st = torch.cos(th)[:, None], torch.sin(th)[:, None]
    u = (pts_all[None, :, 0] - cx[:, None]) * ct + (pts_all[None, :, 1] - cy[:, None]) * st
    v = -(pts_all[None, :, 0] - cx[:, None]) * st + (pts_all[None, :, 1] - cy[:, None]) * ct
    r = torch.sqrt((u / torch.clamp(a_maj, min=1e-6)[:, None]) ** 2 + (v / torch.clamp(a_min, min=1e-6)[:, None]) ** 2)
    R = torch.sqrt(u * u + v * v)
    dist = R * torch.abs(r - 1.0) / torch.clamp(r, min=1e-6)
    inl = ((dist < 2.0) * w).sum(1)
    perim = math.pi * (3.0 * (a_maj + a_min)
                       - torch.sqrt(torch.clamp((3 * a_maj + a_min) * (a_maj + 3 * a_min), min=0.0)))
    coverage = torch.clamp(inl / torch.clamp(0.7 * perim, min=1.0), 0.0, 1.0)
    score = torch.where(n >= min_pts, inl / torch.clamp(n, min=1.0) * coverage, 0.0)
    ok = torch.isfinite(ell).all(1) & (a_maj < 2 * max(H, W)) & (a_min > 1.0)
    ells = torch.where(ok[:, None], ell, 0.0)
    scores = torch.where(ok, score, 0.0)
    scores = torch.where(scores >= score_thresh, scores, 0.0)
    return ells, scores
