"""Evaluation metrics — the port of opencv_contrib_tpu/utils/metrics.py.

- Trajectory: ATE / RPE (the TUM RGB-D benchmark metrics), numpy on host
  trajectories as in the JAX package.
- Image quality: QualityMSE / PSNR / SSIM / GMSD of the quality module
  (quality/README.md:9-22). Maps go through the grid_transform kernel and
  means through grid_reduce.

`mse` and `psnr` return Python floats, as the JAX versions do, so each call
waits for the device once."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.cuda import reduce, transform


# ----------------------------------------------------------------------------
# Trajectory metrics
# ----------------------------------------------------------------------------


def umeyama_align(A: np.ndarray, B: np.ndarray, with_scale: bool = True):
    """Similarity transform (s, R, t) minimizing |s R A + t - B|^2."""
    muA, muB = A.mean(0), B.mean(0)
    Ac, Bc = A - muA, B - muB
    C = Bc.T @ Ac / len(A)
    U, S, Vt = np.linalg.svd(C)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scale:
        var = (Ac**2).sum() / len(A)
        s = float(np.trace(np.diag(S) @ D) / var)
    else:
        s = 1.0
    t = muB - s * R @ muA
    return s, R, t


def ate_rmse(traj_est: np.ndarray, traj_gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of aligned positions). traj_* are
    (N, 3) camera centers or (N, 4, 4) poses."""
    if traj_est.ndim == 3:
        traj_est = traj_est[:, :3, 3]
    if traj_gt.ndim == 3:
        traj_gt = traj_gt[:, :3, 3]
    if align:
        s, R, t = umeyama_align(traj_est, traj_gt)
        traj_est = (s * (R @ traj_est.T)).T + t
    return float(np.sqrt(((traj_est - traj_gt) ** 2).sum(axis=1).mean()))


def rpe(traj_est: np.ndarray, traj_gt: np.ndarray, delta: int = 1):
    """Relative pose error over frame gaps of `delta`: returns (trans_rmse,
    rot_rmse_rad). traj_* are (N, 4, 4)."""
    t_errs, r_errs = [], []
    for i in range(len(traj_est) - delta):
        dE = np.linalg.inv(traj_est[i]) @ traj_est[i + delta]
        dG = np.linalg.inv(traj_gt[i]) @ traj_gt[i + delta]
        E = np.linalg.inv(dG) @ dE
        t_errs.append(np.linalg.norm(E[:3, 3]))
        r_errs.append(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(np.sqrt(np.mean(np.square(r_errs))))


# ----------------------------------------------------------------------------
# Image quality
# ----------------------------------------------------------------------------


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def _mean(m: transform.Map, *arrays: torch.Tensor) -> torch.Tensor:
    return reduce.grid_reduce(m, *arrays, div=float(arrays[0].numel()))


def mse(a, b) -> float:
    a, b = transform.as_2d(_f32(a)), transform.as_2d(_f32(b))
    return float(_mean(transform.sqdiff(), a, b))


def psnr(a, b, max_val: float = 1.0) -> float:
    """QualityPSNR parity."""
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val * max_val / m))


def ssim(a, b, max_val: float = 1.0, sigma: float = 1.5) -> torch.Tensor:
    """QualitySSIM parity (Gaussian-windowed, standard constants) of two
    (H, W) images: the mean of the SSIM map."""
    a, b = _f32(a), _f32(b)
    mu_a = filters.gaussian_blur(a, sigma)
    mu_b = filters.gaussian_blur(b, sigma)
    saa = filters.gaussian_blur(a * a, sigma)
    sbb = filters.gaussian_blur(b * b, sigma)
    sab = filters.gaussian_blur(a * b, sigma)
    s = transform.grid_transform(transform.ssim((0.01 * max_val) ** 2, (0.03 * max_val) ** 2),
                                 mu_a, mu_b, saa, sbb, sab)
    return _mean(transform.ident(), s)


def _half(a: torch.Tensor) -> torch.Tensor:
    """The 2x2 mean of an image with even sides (the GMSD paper's
    downsampling); an image with an odd side is kept as it is."""
    if a.shape[0] % 2 or a.shape[1] % 2:
        return a
    return (a[::2, ::2] + a[1::2, ::2] + a[::2, 1::2] + a[1::2, 1::2]) / 4.0


def gmsd(a, b, c: float = 0.0026) -> torch.Tensor:
    """QualityGMSD parity: the deviation (ddof 0) of the gradient-magnitude
    similarity of Prewitt gradients on the 2x2-downsampled images."""
    a2, b2 = _half(_f32(a)), _half(_f32(b))
    k = torch.zeros((3, 3), device=a2.device)  # [[1, 0, -1]] * 3 / 3, made on the device without a copy
    k[:, 0], k[:, 2] = 1.0, -1.0
    k = k / 3.0
    g = [filters.conv2d(x, kk) for x in (a2, b2) for kk in (k, k.T)]
    gms = transform.grid_transform(transform.gms(c), *g)
    mean = _mean(transform.ident(), gms)
    return torch.sqrt(_mean(transform.sqdev(mean), gms))
