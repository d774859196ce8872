"""Edge-aware filter family, part 2 (the port of
opencv_contrib_tpu/ximgproc/filters_x2.py): the fast global smoother, the
WLS disparity filter, L0 smoothing, the bilateral texture filter, joint
bilateral and weighted median filters, Deriche / Paillou IIR gradients,
the threshold-gated mean, the adaptive manifold filter and the fast
bilateral solver.

The JAX version's 1D recursions are `lax.scan`s whose step carries a whole
(lines,) vector. Here each steps over the scan axis in Python with every
line batched in one tensor and the step's few ops fused where PyTorch has
the fused op (`addcmul`), and no host sync in the loop:
- the Thomas solve of `fast_global_smoother`: 4 launches a forward step and
  1 a backward step, so a pass over W columns is 5 W launches; at 480 x 640
  with n_iters = 3, 3 x 5 (640 + 480) = 16,800 launches a smoothing
  (the WLS filter smooths twice);
- the IIR passes of the Deriche / Paillou gradients: 2nd-order causal and
  anticausal recursions, 4 launches a step each.
Windowed filters are shift-stacks of whole-image ops, as in the JAX
version (their shifts wrap at the borders, `torch.roll` as `jnp.roll`); L0
takes `torch.fft`; the solver's conjugate gradient keeps its scalars on the
device."""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters


# ---------------------------------------------------------------------------
# Fast Global Smoother (WLS, separable tridiagonal solves)
# ---------------------------------------------------------------------------


def _tridiag_thomas(b, a, c, d):
    """Solve tridiagonal systems: a = sub, b = diag, c = super, d = rhs, all
    (N, L), batched over the N rows; the loop walks axis 1 (length L)
    carrying a whole (N,) vector per step."""
    aT, bT, cT, dT = (t.T.contiguous() for t in (a, b, c, d))
    L, N = bT.shape
    cps = torch.empty_like(bT)
    dps = torch.empty_like(bT)
    cp_prev = torch.zeros(N, dtype=bT.dtype, device=bT.device)
    dp_prev = cp_prev
    for i in range(L):
        denom = torch.addcmul(bT[i], aT[i], cp_prev, value=-1.0)
        torch.div(cT[i], denom, out=cps[i])
        torch.div(torch.addcmul(dT[i], aT[i], dp_prev, value=-1.0), denom, out=dps[i])
        cp_prev, dp_prev = cps[i], dps[i]
    xs = torch.empty_like(bT)
    x_next = torch.zeros(N, dtype=bT.dtype, device=bT.device)
    for i in range(L - 1, -1, -1):
        torch.addcmul(dps[i], cps[i], x_next, value=-1.0, out=xs[i])
        x_next = xs[i]
    return xs.T


def _fgs_pass(src, guide, lam, sigma_color):
    """One horizontal WLS pass: per-row solve (I + lam * L_w) u = src."""
    diff = torch.abs(guide[:, 1:] - guide[:, :-1])
    if diff.ndim == 3:  # color guide
        diff = diff.sum(-1)
    w = torch.exp(-diff / sigma_color)  # (H, W-1)
    zero = torch.zeros((w.shape[0], 1), dtype=w.dtype, device=w.device)
    wl = torch.cat([zero, w], dim=1)  # weight to left neighbor
    wr = torch.cat([w, zero], dim=1)  # weight to right neighbor
    a = -lam * wl
    c = -lam * wr
    b = 1.0 + lam * (wl + wr)
    return _tridiag_thomas(b, a, c, src)


def fast_global_smoother(guide: torch.Tensor, src: torch.Tensor, lam: float = 128.0, sigma_color: float = 0.05,
                         n_iters: int = 3) -> torch.Tensor:
    """Fast global smoother (parity: cv::ximgproc::FastGlobalSmootherFilter,
    fgs_filter.cpp): separable WLS, alternating horizontal/vertical
    tridiagonal solves with the per-iteration lambda attenuation schedule
    lam_t = 1.5 * lam * 4^(T-t) / (4^T - 1)."""
    out = src.to(torch.float32)
    gd = guide.to(torch.float32)
    gT = torch.swapaxes(gd, 0, 1)
    T = n_iters
    for t in range(1, T + 1):
        lam_t = 1.5 * lam * (4.0 ** (T - t)) / (4.0 ** T - 1.0)
        out = _fgs_pass(out, gd, lam_t, sigma_color)
        out = _fgs_pass(out.T, gT, lam_t, sigma_color).T
    return out


def disparity_wls_filter(disparity_left: torch.Tensor, disparity_right: torch.Tensor, guide: torch.Tensor,
                         lam: float = 8000.0, sigma_color: float = 1.0, lrc_thresh: float = 1.5):
    """Confidence-weighted disparity post-filtering (parity:
    cv::ximgproc::DisparityWLSFilter, disparity_filters.cpp).

    Confidence from the left-right consistency check (both maps given with
    positive disparity magnitudes); the filtered map is
    FGS(conf * d) / FGS(conf). Returns (filtered_disparity, confidence)."""
    dl = disparity_left.to(torch.float32)
    dr = disparity_right.to(torch.float32)
    H, W = dl.shape
    xs = torch.arange(W, device=dl.device)[None, :].expand(H, W).to(torch.float32)
    # sample right disparity at x - dL
    xr = torch.clamp(xs - dl, 0, W - 1)
    x0 = torch.floor(xr).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    f = xr - x0
    dR = (1 - f) * torch.gather(dr, 1, x0) + f * torch.gather(dr, 1, x1)
    lrc_err = torch.abs(dl - dR)
    conf = torch.clamp(1.0 - lrc_err / lrc_thresh, 0.0, 1.0)
    num = fast_global_smoother(guide, conf * dl, lam, sigma_color / 255.0)
    den = fast_global_smoother(guide, conf, lam, sigma_color / 255.0)
    return num / torch.clamp(den, min=1e-6), conf


# ---------------------------------------------------------------------------
# L0 gradient minimization (FFT solves)
# ---------------------------------------------------------------------------


def l0_smooth(img: torch.Tensor, lam: float = 0.02, kappa: float = 2.0, max_iters: int = 12) -> torch.Tensor:
    """L0 gradient minimization (parity: cv::ximgproc::l0Smooth,
    l0_smooth.cpp / Xu et al. 2011): alternate the gradient hard-threshold
    with an FFT screened-Poisson solve; all spectra precomputed once. beta
    doubles (by kappa) each iteration on the host: it is a Python number
    in both versions' arithmetic."""
    f = img.to(torch.float32)
    dev = f.device
    H, W = f.shape[:2]
    fx = torch.zeros((H, W), device=dev)
    fx[0, 0].fill_(-1.0)
    fx[0, W - 1].fill_(1.0)
    fy = torch.zeros((H, W), device=dev)
    fy[0, 0].fill_(-1.0)
    fy[H - 1, 0].fill_(1.0)
    Fx = torch.fft.fft2(fx)
    Fy = torch.fft.fft2(fy)
    denom_base = torch.abs(Fx) ** 2 + torch.abs(Fy) ** 2
    Fimg = torch.fft.fft2(f, dim=(0, 1))
    cFx, cFy = torch.conj(Fx), torch.conj(Fy)
    if f.ndim == 3:
        cFx, cFy, denom_base = cFx[..., None], cFy[..., None], denom_base[..., None]
    u = f
    beta = np.float32(2.0 * lam)
    for _ in range(max_iters):
        gx = torch.roll(u, -1, 1) - u
        gy = torch.roll(u, -1, 0) - u
        mag2 = gx * gx + gy * gy
        if mag2.ndim == 3:
            mag2 = mag2.sum(-1, keepdim=True)
        keep = mag2 >= float(np.float32(lam) / beta)
        h = torch.where(keep, gx, 0.0)
        v = torch.where(keep, gy, 0.0)
        Fh = torch.fft.fft2(h, dim=(0, 1))
        Fv = torch.fft.fft2(v, dim=(0, 1))
        num = Fimg + float(beta) * (cFx * Fh + cFy * Fv)
        den = 1.0 + float(beta) * denom_base
        u = torch.real(torch.fft.ifft2(num / den, dim=(0, 1)))
        beta = np.float32(beta * np.float32(kappa))
    return u


# ---------------------------------------------------------------------------
# Bilateral texture filter (patch shift)
# ---------------------------------------------------------------------------


def _window_extreme(x: torch.Tensor, fr: int, op) -> torch.Tensor:
    m = x
    for dy in range(-fr, fr + 1):
        for dx in range(-fr, fr + 1):
            m = op(m, torch.roll(x, (dy, dx), (0, 1)))
    return m


def bilateral_texture_filter(img: torch.Tensor, fr: int = 3, n_iters: int = 1, sigma_alpha: float | None = None,
                             sigma_avg: float | None = None) -> torch.Tensor:
    """Bilateral texture filter (parity: cv::ximgproc::bilateralTextureFilter,
    bilateral_texture_filter.cpp / Cho et al. SIGGRAPH 2014).

    Per iteration: box blur B, modified relative total variation mRTV per
    patch, patch shift = the window offset minimizing mRTV (a shift-stack
    argmin of whole-image maps), alpha-blended guide G', then a joint
    bilateral transfer of the input toward G'."""
    if sigma_alpha is None:
        sigma_alpha = 5.0 * fr
    if sigma_avg is None:
        sigma_avg = 0.05 * math.sqrt(2.0 * fr + 1.0)
    out = img.to(torch.float32)
    for _ in range(n_iters):
        B = filters.box_filter(out, fr)
        gy, gx = filters.gradients(out)
        gmag = torch.sqrt(gy * gy + gx * gx)
        delta = _window_extreme(out, fr, torch.maximum) - _window_extreme(out, fr, torch.minimum)
        gsum = filters.box_filter(gmag, fr) * (2 * fr + 1) ** 2
        gmax = _window_extreme(gmag, fr, torch.maximum)
        mrtv = delta * gmax / (gsum + 1e-9)
        best_mrtv = mrtv
        best_B = B
        for dy in range(-fr, fr + 1):
            for dx in range(-fr, fr + 1):
                if dy == 0 and dx == 0:
                    continue
                cand = torch.roll(mrtv, (dy, dx), (0, 1))
                candB = torch.roll(B, (dy, dx), (0, 1))
                take = cand < best_mrtv
                best_mrtv = torch.where(take, cand, best_mrtv)
                best_B = torch.where(take, candB, best_B)
        alpha = 2.0 / (1.0 + torch.exp(-sigma_alpha * (mrtv - best_mrtv))) - 1.0
        Gp = alpha * best_B + (1.0 - alpha) * B
        out = joint_bilateral_filter(Gp, out, sigma_s=float(fr), sigma_r=sigma_avg, radius=fr)
    return out


def joint_bilateral_filter(guide: torch.Tensor, src: torch.Tensor, sigma_s: float = 3.0, sigma_r: float = 0.1,
                           radius: int = 4) -> torch.Tensor:
    """Joint/cross bilateral filter (parity: cv::ximgproc::jointBilateralFilter,
    joint_bilateral_filter.cpp) as a shift-stack of whole-image multiplies."""
    guide = guide.to(torch.float32)
    src = src.to(torch.float32)
    num = torch.zeros_like(src)
    den = torch.zeros_like(src)
    inv2ss = 1.0 / (2 * sigma_s * sigma_s)
    inv2sr = 1.0 / (2 * sigma_r * sigma_r)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            gs = math.exp(-(dy * dy + dx * dx) * inv2ss)
            g_shift = torch.roll(guide, (dy, dx), (0, 1))
            s_shift = torch.roll(src, (dy, dx), (0, 1))
            d2 = (g_shift - guide) ** 2
            if d2.ndim == 3:
                d2 = d2.sum(-1)
            w = gs * torch.exp(-d2 * inv2sr)
            if src.ndim == 3:
                w = w[..., None]
            num = num + w * s_shift
            den = den + w
    return num / torch.clamp(den, min=1e-9)


# ---------------------------------------------------------------------------
# Weighted median filter (joint-histogram, constant-time formulation)
# ---------------------------------------------------------------------------


def weighted_median_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 5, sigma: float = 25.5 / 255.0,
                           n_bins: int = 16) -> torch.Tensor:
    """Weighted median filter (parity: cv::ximgproc::weightedMedianFilter,
    weighted_median_filter.cpp / Zhang et al. 100+ times faster WMF).

    Quantize src into n_bins; the bilateral-affinity-weighted count of each
    bin is a joint-bilateral smoothing of its indicator image (all bins in
    one (n_bins, H, W) stack: the affinities are shared); the output is the
    first bin whose weighted CDF crosses half."""
    src = src.to(torch.float32)
    lo = src.min()
    hi = src.max()
    span = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp(((src - lo) / span * (n_bins - 1) + 0.5).to(torch.int32), 0, n_bins - 1)
    onehot = (q[None, :, :] == torch.arange(n_bins, device=src.device)[:, None, None]).to(torch.float32)
    g = guide.to(torch.float32)
    sigma_s = radius / 2.0
    num = torch.zeros_like(onehot)
    den = torch.zeros_like(src)
    inv2ss = 1.0 / (2 * sigma_s * sigma_s)
    inv2sr = 1.0 / (2 * sigma * sigma)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            gs = math.exp(-(dy * dy + dx * dx) * inv2ss)
            d2 = (torch.roll(g, (dy, dx), (0, 1)) - g) ** 2
            if d2.ndim == 3:
                d2 = d2.sum(-1)
            w = gs * torch.exp(-d2 * inv2sr)
            num = num + w * torch.roll(onehot, (dy, dx), (1, 2))
            den = den + w
    smooth = num / torch.clamp(den, min=1e-9)
    cdf = torch.cumsum(smooth, dim=0)
    half = 0.5 * cdf[-1]
    med_bin = torch.argmax((cdf >= half[None]).to(torch.uint8), dim=0)
    return lo + med_bin.to(torch.float32) / (n_bins - 1) * span


# ---------------------------------------------------------------------------
# Deriche / Paillou IIR gradient filters
# ---------------------------------------------------------------------------


def _iir2_axis1(x, a1, a2, a3, a4, b1, b2):
    """Generic 2nd-order causal + anticausal IIR along axis 1; each step
    carries an (H,) vector. The coefficients are float32 numbers, as the
    JAX version's traced scalars are."""
    xT = x.T.contiguous()  # (W, H)
    L, H = xT.shape
    z = torch.zeros(H, dtype=xT.dtype, device=xT.device)
    yp = torch.empty_like(xT)
    y1, y2, x1 = z, z, z
    for i in range(L):
        xn = xT[i]
        # a1 xn + a2 x1 + b1 y1 + b2 y2, in the JAX version's order
        y = torch.add(a1 * xn, x1, alpha=a2, out=yp[i]).add_(y1, alpha=b1).add_(y2, alpha=b2)
        y1, y2, x1 = y, y1, xn
    ym = torch.empty_like(xT)
    y1, y2, x1, x2 = z, z, z, z
    for i in range(L - 1, -1, -1):
        y = torch.add(a3 * x1, x2, alpha=a4, out=ym[i]).add_(y1, alpha=b1).add_(y2, alpha=b2)
        y1, y2, x1, x2 = y, y1, xT[i], x1
    return (yp + ym).T


def _coef(*vals):
    return [float(np.float32(v)) for v in vals]


def _deriche_smooth_axis1(x, alpha: float):
    f = np.float32
    ea = np.exp(-f(alpha))
    e2a = np.exp(f(-2.0) * f(alpha))
    k = (f(1) - ea) ** 2 / (f(1) + f(2) * f(alpha) * ea - e2a)
    a1 = k
    a2 = k * ea * (f(alpha) - f(1.0))
    a3 = k * ea * (f(alpha) + f(1.0))
    a4 = -k * e2a
    b1 = f(2.0) * ea
    b2 = -e2a
    return _iir2_axis1(x, *_coef(a1, a2, a3, a4, b1, b2))


def _deriche_derive_axis1(x, alpha: float):
    """Deriche derivative operator along axis 1: antisymmetric causal /
    anticausal recursion with gain normalized so a unit ramp maps to slope 1."""
    f = np.float32
    ea = np.exp(-f(alpha))
    e2a = np.exp(f(-2.0) * f(alpha))
    a = -((f(1) - ea) ** 3) / (f(2.0) * (f(1) + ea))
    b1 = f(2.0) * ea
    b2 = -e2a
    yp = _iir2_axis1(x, *_coef(0.0, a, 0.0, 0.0, b1, b2))
    ym = _iir2_axis1(x, *_coef(0.0, 0.0, -a, 0.0, b1, b2))
    return yp + ym


def deriche_gradient_x(img: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Deriche gradient along x (parity: cv::ximgproc::GradientDericheX,
    deriche_filter.cpp): IIR exponential smoothing along y, IIR derivative
    along x, O(1) per pixel independent of alpha."""
    s = _deriche_smooth_axis1(img.to(torch.float32).T, alpha).T  # smooth along y
    return _deriche_derive_axis1(s, alpha)


def deriche_gradient_y(img: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Deriche gradient along y (parity: cv::ximgproc::GradientDericheY)."""
    s = _deriche_smooth_axis1(img.to(torch.float32), alpha)  # smooth along x
    return _deriche_derive_axis1(s.T, alpha).T


def _paillou_eff(alpha: float, omega: float) -> float:
    f = np.float32
    return float(np.sqrt(f(alpha) * f(alpha) + f(omega) * f(omega)))


def paillou_gradient_x(img: torch.Tensor, alpha: float = 1.0, omega: float = 0.1) -> torch.Tensor:
    """Paillou gradient along x (parity: cv::ximgproc::GradientPaillouX,
    paillou_filter.cpp): the same IIR machinery, damped by omega via the
    effective smoothing constant sqrt(alpha^2 + omega^2)."""
    s = _deriche_smooth_axis1(img.to(torch.float32).T, _paillou_eff(alpha, omega)).T
    return _deriche_derive_axis1(s, alpha)


def paillou_gradient_y(img: torch.Tensor, alpha: float = 1.0, omega: float = 0.1) -> torch.Tensor:
    """Paillou gradient along y (parity: cv::ximgproc::GradientPaillouY)."""
    s = _deriche_smooth_axis1(img.to(torch.float32), _paillou_eff(alpha, omega))
    return _deriche_derive_axis1(s.T, alpha).T


# ---------------------------------------------------------------------------
# Edge-preserving (threshold-gated) mean filter
# ---------------------------------------------------------------------------


def edge_preserving_filter(img: torch.Tensor, radius: int = 3, threshold: float = 0.08) -> torch.Tensor:
    """Threshold-gated windowed mean (parity:
    cv::ximgproc::edgePreservingFilter, edgepreserving_filter.cpp): average
    only over window pixels whose value differs from the center by less than
    the threshold."""
    f = img.to(torch.float32)
    num = torch.zeros_like(f)
    den = torch.zeros_like(f)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            s = torch.roll(f, (dy, dx), (0, 1))
            d = torch.abs(s - f)
            if d.ndim == 3:
                d = d.mean(-1, keepdim=True)
            m = (d < threshold).to(torch.float32)
            num = num + m * s
            den = den + m
    return num / torch.clamp(den, min=1.0)


# ---------------------------------------------------------------------------
# Adaptive manifold filter (depth-2 manifold tree)
# ---------------------------------------------------------------------------


def _rf_blur(x, guide, sigma_s, sigma_r):
    """Recursive edge-aware blur over the guide's manifold: the RF filter of
    the domain transform, reused as the AM low-pass."""
    from opencv_contrib_tpu_torch.ximgproc.filters_x import dt_filter

    if x.ndim == 3:
        return torch.stack([dt_filter(guide, x[..., c], sigma_s, sigma_r, n_iters=2) for c in range(x.shape[-1])],
                           dim=-1)
    return dt_filter(guide, x, sigma_s, sigma_r, n_iters=2)


def adaptive_manifold_filter(guide: torch.Tensor, src: torch.Tensor, sigma_s: float = 16.0,
                             sigma_r: float = 0.2) -> torch.Tensor:
    """Adaptive manifold filter (parity: cv::ximgproc::AdaptiveManifoldFilter,
    adaptive_manifold_filter_n.cpp / Gastal & Oliveira 2012), depth-2
    manifold tree: the root manifold is a low-pass of the guide; children
    split on the sign of the residual's principal direction; each manifold
    accumulates Gaussian-distance-weighted splats blurred along the manifold."""
    g = guide.to(torch.float32)
    f = src.to(torch.float32)
    gg = g if g.ndim == 2 else g.mean(-1)

    eta0 = _rf_blur(g, gg, sigma_s, sigma_r * 10.0)  # near-spatial low-pass
    resid = g - eta0
    rflat = resid.reshape(-1, 1) if resid.ndim == 2 else resid.reshape(-1, resid.shape[-1])
    # principal direction of the residual (power iteration, 3 steps)
    C = rflat.T @ rflat
    v = torch.ones((C.shape[0],), dtype=torch.float32, device=C.device)
    for _ in range(3):
        v = C @ v
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-9)
    proj = (rflat @ v).reshape(gg.shape)
    masks = [proj >= 0, proj < 0]

    manifolds = [eta0]
    for m in masks:
        mf = m.to(torch.float32)
        num = _rf_blur(g * (mf[..., None] if g.ndim == 3 else mf), gg, sigma_s, sigma_r * 10.0)
        den = _rf_blur(mf, gg, sigma_s, sigma_r * 10.0)
        manifolds.append(num / torch.clamp(den[..., None] if g.ndim == 3 else den, min=1e-6))

    num = torch.zeros_like(f)
    den = torch.zeros_like(f if f.ndim == 2 else f[..., :1])
    for eta in manifolds:
        d2 = (g - eta) ** 2
        if d2.ndim == 3:
            d2 = d2.sum(-1)
        w = torch.exp(-d2 / (2.0 * sigma_r * sigma_r))
        wf = w[..., None] * f if f.ndim == 3 else w * f
        bw = _rf_blur(w, gg, sigma_s, sigma_r)
        bwf = _rf_blur(wf, gg, sigma_s, sigma_r)
        num = num + (w[..., None] if f.ndim == 3 else w) * bwf
        den = den + (w[..., None] if f.ndim == 3 else w) * (bw[..., None] if f.ndim == 3 else bw)
    return num / torch.clamp(den, min=1e-6)


# ---------------------------------------------------------------------------
# Fast bilateral solver (CG over a windowed bilateral affinity)
# ---------------------------------------------------------------------------


def fast_bilateral_solver(guide: torch.Tensor, target: torch.Tensor, confidence: torch.Tensor,
                          sigma_s: float = 8.0, sigma_r: float = 8.0 / 255.0, lam: float = 32.0, radius: int = 4,
                          cg_iters: int = 25) -> torch.Tensor:
    """Fast bilateral solver (parity: cv::ximgproc::FastBilateralSolverFilter,
    fbs_filter.cpp / Barron & Poole 2016): minimize
    sum_p c_p (x_p - t_p)^2 + lam * sum_pq W_pq (x_p - x_q)^2 by conjugate
    gradient over a windowed bilateral affinity whose matvec is a
    shift-stack. The CG scalars stay 0-d tensors on the device."""
    g = guide.to(torch.float32)
    t = target.to(torch.float32)
    c = confidence.to(torch.float32)
    inv2ss = 1.0 / (2 * sigma_s * sigma_s)
    inv2sr = 1.0 / (2 * sigma_r * sigma_r)

    shifts = [(dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1) if (dy, dx) != (0, 0)]
    ws = []
    for dy, dx in shifts:
        d2 = (torch.roll(g, (dy, dx), (0, 1)) - g) ** 2
        if d2.ndim == 3:
            d2 = d2.sum(-1)
        ws.append(torch.exp(-(dy * dy + dx * dx) * inv2ss - d2 * inv2sr))
    wsum = ws[0]
    for w in ws[1:]:
        wsum = wsum + w
    diag = c + lam * wsum

    def matvec(x):
        out = diag * x
        for (dy, dx), w in zip(shifts, ws):
            out = out - lam * w * torch.roll(x, (dy, dx), (0, 1))
        return out

    def vdot(a, b):
        return torch.sum(a * b)

    b = c * t
    x = t
    r = b - matvec(x)
    p = r
    rs = vdot(r, r)
    for _ in range(cg_iters):
        Ap = matvec(p)
        alpha = rs / torch.clamp(vdot(p, Ap), min=1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = vdot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=1e-12)) * p
        rs = rs_new
    return x
