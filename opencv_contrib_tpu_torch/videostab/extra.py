"""videostab completion: RANSAC keypoint motion, the L1-optimal trajectory,
deblurring, inpainting and wobble suppression (the port of
opencv_contrib_tpu/videostab/extra.py).

Reference anchors (videostab):
- global_motion.cpp: MotionEstimatorRansacL2 (::estimate)
- motion_stabilizing.cpp: LpMotionStabilizer (the L1-optimal camera path,
  here by ADMM on |D1|+|D2|+|D3| with a projected crop constraint, the
  twin's solver)
- deblurring.cpp: calcBlurriness, WeightingDeblurer::deblur
- inpainting.cpp: ColorAverageInpainter, ConsistentMosaicInpainter
- wobble_suppression.cpp: MoreAccurateMotionWobbleSuppressor::suppress

The twin's scans are Python loops here, each step on the device with no
host read: the LP trajectory's 150 ADMM steps each run 25 conjugate-gradient
steps, whose constant operator is one (N, N) matrix product (about 15
launches a CG step on the card). RANSAC draws its
hypotheses from a `torch.Generator` (`_hypotheses`) and refits on the
inliers by `torch.linalg.lstsq` with the "gels" driver on every device (the
card has no other): a QR least squares, which agrees with the twin's SVD
solution while the inliers span rank 3 (three non-collinear points); below
that gels returns an arbitrary solution where the twin's is the minimum
norm one.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.image import grid_coords, remap, warp_perspective
from opencv_contrib_tpu_torch.utils.device import as_float, to_device
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


# ---------------------------------------------------------------------------
# Keypoint RANSAC global motion (MotionEstimatorRansacL2)
# ---------------------------------------------------------------------------


def _hypotheses(gen: torch.Generator, n_hyps: int, msize: int, N: int, device) -> torch.Tensor:
    """(n_hyps, msize) point indices in [0, N), drawn from `gen` on its
    device (the points' device)."""
    return torch.randint(0, N, (n_hyps, msize), generator=gen, device=gen.device).to(device)


def _fit_minimal(model: str, a, b):
    """Motions (H, 2, 3) through each hypothesis' points a, b (H, m, 2)."""
    Hn = a.shape[0]
    dev = a.device
    if model == "translation":
        t = (b - a).reshape(Hn, 2)
        eye = torch.eye(2, 3, device=dev)[None].expand(Hn, 2, 3)
        return eye + torch.cat([torch.zeros((Hn, 2, 2), device=dev), t[:, :, None]], 2)
    if model == "similarity":
        # two points determine scale + rotation + translation
        da = a[:, 1] - a[:, 0]
        db = b[:, 1] - b[:, 0]
        den = torch.clamp(da[:, 0] ** 2 + da[:, 1] ** 2, min=1e-9)
        p = (da[:, 0] * db[:, 0] + da[:, 1] * db[:, 1]) / den
        q = (da[:, 0] * db[:, 1] - da[:, 1] * db[:, 0]) / den
        R = torch.stack([torch.stack([p, -q], -1), torch.stack([q, p], -1)], 1)  # (H, 2, 2)
        t = b[:, 0] - (R[:, :, 0] * a[:, 0, None, 0] + R[:, :, 1] * a[:, 0, None, 1])
        return torch.cat([R, t[:, :, None]], 2)
    # affine: three points
    A = torch.cat([a, torch.ones((Hn, 3, 1), device=dev)], 2)
    sol = torch.linalg.solve_ex(A + 1e-9 * torch.eye(3, device=dev), b)[0]
    return sol.transpose(1, 2)


def ransac_motion(pts0: torch.Tensor, pts1: torch.Tensor, gen: torch.Generator, model: str = "similarity",
                  thresh: float = 2.0, n_hyps: int = 256):
    """Global motion from correspondences by vectorized RANSAC
    (MotionEstimatorRansacL2::estimate): all n_hyps hypotheses fit and
    scored at once, the best refit on its inliers. Returns the (3, 3)
    homogeneous motion and the inlier mask."""
    pts0, pts1 = as_float(pts0), as_float(pts1).to(as_float(pts0).device)
    dev = pts0.device
    N = pts0.shape[0]
    msize = {"translation": 1, "similarity": 2, "affine": 3}[model]
    idx = _hypotheses(gen, n_hyps, msize, N, dev)
    with f32_matmul_precision():
        Ms = _fit_minimal(model, pts0[idx], pts1[idx])  # (n_hyps, 2, 3)
        pred = torch.einsum("nj,hij->hni", pts0, Ms[:, :, :2]) + Ms[:, None, :, 2]
        scores = (torch.linalg.norm(pred - pts1[None], dim=2) < thresh).sum(1)
        best = Ms.index_select(0, torch.argmax(scores).reshape(1))[0]
        # refit on the inliers (weighted least squares, weights = the inlier mask)
        pred = pts0 @ best[:, :2].T + best[:, 2]
        w = (torch.linalg.norm(pred - pts1, dim=1) < thresh).to(torch.float32)
        A = torch.cat([pts0, torch.ones((N, 1), device=dev)], 1) * w[:, None]
        B = pts1 * w[:, None]
        sol = torch.linalg.lstsq(A, B, driver="gels").solution.T  # (2, 3)
    return torch.cat([sol, torch.eye(3, device=dev)[2:]], 0), w > 0


# ---------------------------------------------------------------------------
# L1-optimal trajectory (LpMotionStabilizer)
# ---------------------------------------------------------------------------


def _d1(S):
    return S[1:] - S[:-1]


def _d2(S):
    return S[2:] - 2 * S[1:-1] + S[:-2]


def _d3(S):
    return S[3:] - 3 * S[2:-1] + 3 * S[1:-2] - S[:-3]


def _pad_rows(r, before: int, after: int):
    return torch.nn.functional.pad(r, (0, 0, before, after))


def _d1t(r):
    """The adjoint of D1, the twin's scatter-adds in their order."""
    return _pad_rows(r, 1, 0) + _pad_rows(-r, 0, 1)


def _d2t(r):
    return _pad_rows(r, 2, 0) + _pad_rows(-2 * r, 1, 1) + _pad_rows(r, 0, 2)


def _d3t(r):
    return _pad_rows(r, 3, 0) + _pad_rows(-3 * r, 2, 1) + _pad_rows(3 * r, 1, 2) + _pad_rows(-r, 0, 3)


def lp_stabilize_trajectory(traj: torch.Tensor, bound: float = 0.1, w1: float = 1.0, w2: float = 10.0,
                            w3: float = 100.0, rho: float = 50.0, n_iters: int = 150):
    """The L1-optimal smoothed camera path (LpMotionStabilizer, Grundmann et
    al. 2011): minimize w1|D1 S| + w2|D2 S| + w3|D3 S| with S kept within
    `bound` of the original path C (N, P), by ADMM with soft-thresholded
    difference variables and a projected crop constraint (CG on the constant
    SPD inner system). Returns S."""
    C = as_float(traj)
    del rho  # the constraint is a projection
    tau = 1e-2  # tie to the original path (pins the null space)
    pen = 1.0  # ADMM penalty
    # the inner system's operator tau I + pen sum_k D_k^T D_k is constant: one
    # (N, N) matrix (its entries small integers plus tau), applied by one
    # product a CG step where the twin composes six difference operators
    eye = torch.eye(C.shape[0], dtype=C.dtype, device=C.device)
    Amat = tau * eye + pen * (_d1t(_d1(eye)) + _d2t(_d2(eye)) + _d3t(_d3(eye)))

    def A(S):
        with f32_matmul_precision():
            return Amat @ S

    def cg(b, x0, iters=25):
        x = x0
        r = b - A(x0)
        p, rs = r, (r * r).sum()
        for _ in range(iters):
            Ap = A(p)
            alpha = rs / torch.clamp((p * Ap).sum(), min=1e-12)
            x = x + alpha * p
            r = r - alpha * Ap
            rs2 = (r * r).sum()
            p = r + (rs2 / torch.clamp(rs, min=1e-12)) * p
            rs = rs2
        return x

    def soft(x, t):
        return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)

    S = C
    z1, z2, z3 = _d1(S), _d2(S), _d3(S)
    u1, u2, u3 = torch.zeros_like(z1), torch.zeros_like(z2), torch.zeros_like(z3)
    for _ in range(n_iters):
        b = tau * C + pen * (_d1t(z1 - u1) + _d2t(z2 - u2) + _d3t(z3 - u3))
        S = cg(b, S)
        S = torch.clamp(S, C - bound, C + bound)  # crop-window projection
        d1, d2, d3 = _d1(S), _d2(S), _d3(S)
        z1 = soft(d1 + u1, w1 / pen)
        z2 = soft(d2 + u2, w2 / pen)
        z3 = soft(d3 + u3, w3 / pen)
        u1 = u1 + d1 - z1
        u2 = u2 + d2 - z2
        u3 = u3 + d3 - z3
    return S


# ---------------------------------------------------------------------------
# Deblurring
# ---------------------------------------------------------------------------


def calc_blurriness(frame: torch.Tensor) -> torch.Tensor:
    """Inverse gradient energy (cv::videostab::calcBlurriness): smaller =
    sharper."""
    gy, gx = filters.gradients(as_float(frame))
    H, W = frame.shape[:2]
    return 1.0 / torch.clamp((gx * gx + gy * gy).sum() / (H * W), min=1e-12)


def _inv(M):
    return torch.linalg.inv_ex(M)[0]


def _chain_motion(motions, src: int, dst: int, device=None):
    """The (3, 3) chain mapping frame src coords -> frame dst coords
    (getMotion semantics, global_motion.cpp)."""
    if device is None:
        device = as_float(motions[0]).device
    M = torch.eye(3, device=device)
    with f32_matmul_precision():
        if src < dst:
            for k in range(src, dst):
                M = to_device(motions[k], device) @ M
        else:
            for k in range(dst, src):
                M = to_device(motions[k], device) @ M
            M = _inv(M)
    return M


def weighting_deblur(frames, motions, idx: int, radius: int = 2, sensitivity: float = 0.1):
    """Deblur frame idx by accumulating sharper neighbours warped into its
    coordinates (WeightingDeblurer::deblur). motions[i] is the (3, 3) map
    from frame i to frame i+1 coordinates."""
    frames = [as_float(f) for f in frames]
    dev = frames[idx].device
    frames = [f.to(dev) for f in frames]
    n = len(frames)
    b = torch.stack([calc_blurriness(f) for f in frames])
    acc = frames[idx]
    wsum = torch.ones((), device=dev)
    for j in range(max(0, idx - radius), min(n, idx + radius + 1)):
        if j == idx:
            continue
        # the weight grows where neighbour j is sharper than idx
        w = torch.clamp(b[idx] / torch.clamp(b[j], min=1e-12) - 1.0, 0.0, 2.0)
        w = torch.where(w > sensitivity, w, torch.zeros_like(w))
        M = _chain_motion(motions, j, idx, dev)  # j -> idx coordinates
        warped = warp_perspective(frames[j], _inv(M))
        acc = acc + w * warped
        wsum = wsum + w
    return acc / wsum


# ---------------------------------------------------------------------------
# Inpainting
# ---------------------------------------------------------------------------


def color_average_inpaint(frame: torch.Tensor, mask: torch.Tensor, n_iters: int = 50) -> torch.Tensor:
    """Fill masked pixels by iterative neighbour averaging
    (ColorAverageInpainter: a fixed-point diffusion to the harmonic fill)."""
    f = as_float(frame)
    m = torch.as_tensor(mask).to(device=f.device, dtype=torch.bool)
    x = torch.where(m, f.mean(), f)
    for _ in range(n_iters):
        avg = (torch.roll(x, 1, 0) + torch.roll(x, -1, 0) + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)) / 4.0
        x = torch.where(m, avg, f)
    return x


def _median0(S: torch.Tensor) -> torch.Tensor:
    """The median over axis 0 as `jnp.median` takes it: the middle of an odd
    count, the mean of the two middles of an even one (`torch.median`
    returns the lower)."""
    s = torch.sort(S, dim=0).values
    K = S.shape[0]
    if K % 2:
        return s[K // 2]
    return 0.5 * (s[K // 2 - 1] + s[K // 2])


def consistent_mosaic_inpaint(frames, motions, idx: int, mask, radius: int = 2, stdev_thresh: float = 20.0):
    """Fill frame idx's masked pixels with the per-pixel median of the
    neighbouring frames warped into its coordinates
    (ConsistentMosaicInpainter); K is even near the clip's ends."""
    f = as_float(frames[idx])
    dev = f.device
    n = len(frames)
    stack = []
    for j in range(max(0, idx - radius), min(n, idx + radius + 1)):
        M = _chain_motion(motions, j, idx, dev)
        stack.append(warp_perspective(as_float(frames[j]).to(dev), _inv(M)))
    S = torch.stack(stack)  # (K, H, W)
    med = _median0(S)
    std = S.std(dim=0, correction=0)
    fill = torch.where(std < stdev_thresh, med, f)
    return torch.where(torch.as_tensor(mask).to(device=dev, dtype=torch.bool), fill, f)


# ---------------------------------------------------------------------------
# Wobble suppression
# ---------------------------------------------------------------------------


def wobble_suppress(frame, idx: int, period: int, motions, motions2, stab_motion):
    """Suppress rolling-shutter wobble for frame idx
    (MoreAccurateMotionWobbleSuppressor::suppress): anchor frames every
    `period`; warp maps from the pass-1 (motions) and pass-2 (motions2)
    chains at the left and right anchors, blended by temporal distance."""
    f = as_float(frame)
    n = len(motions) + 1
    if idx % period == 0:
        return f
    dev = f.device
    k1 = idx // period * period
    k2 = min(k1 + period, n - 1)
    S1 = to_device(stab_motion, dev)
    with f32_matmul_precision():
        S1i = _inv(S1)
        ML = S1 @ _chain_motion(motions2, k1, idx, dev) @ _inv(_chain_motion(motions, k1, idx, dev)) @ S1i
        MR = S1 @ _inv(_chain_motion(motions2, idx, k2, dev)) @ _chain_motion(motions, idx, k2, dev) @ S1i
    return _wobble_remap(f, ML, MR, float(idx - k1), float(k2 - idx))


def _wobble_remap(frame, ML, MR, wl, wr):
    H, W = frame.shape[:2]
    ys, xs = grid_coords(H, W, device=frame.device)

    def apply(M):
        z = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
        z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        return ((M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) / z, (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / z)

    yl, xl = apply(ML)
    yr, xr = apply(MR)
    tot = max(wl + wr, 1e-9)
    my = (wl * yl + wr * yr) / tot
    mx = (wl * xl + wr * xr) / tot
    return remap(frame, my, mx)
