"""Fast point-to-plane ICP with projective data association (the port of
opencv_contrib_tpu/rgbd/icp.py; fast_icp.cpp ICPImpl::estimateTransformT).

Coarse-to-fine over the pyramid with fixed per-level iteration counts; each
iteration builds the 6x7 normal system [A|b] (getAb) and solves it. On the
card getAb is one `grid_reduce_vec` kernel launch (ops/cuda/reduce.py); no
step of the loop reads a value back to the host.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.core import se3
from opencv_contrib_tpu_torch.ops.cuda import reduce
from opencv_contrib_tpu_torch.rgbd.frame import DepthFrame, level_intrinsics


def build_system(T: torch.Tensor, src: DepthFrame, dst: DepthFrame, intr: torch.Tensor,
                 dist_thresh: float = 0.1, angle_thresh: float = 0.52):
    """The getAb step: (A (6, 6), b (6,), n_corr, mean_err) for pose T
    mapping source camera frame -> target camera frame. A CUDA frame goes
    through the kernel, a CPU frame through the plain einsum form."""
    return reduce.icp_getab(T, src.points, src.normals, src.valid, dst.points, dst.normals, dst.valid, intr,
                            dist_thresh, angle_thresh)


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Damped 6x6 solve. `solve_ex` skips the error check, which would
    synchronise the host; a singular system gives non-finite values that
    the caller masks."""
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(A + 1e-6 * eye, b)[0]


def icp_level(T0: torch.Tensor, src: DepthFrame, dst: DepthFrame, intr: torch.Tensor, iters: int = 5,
              dist_thresh: float = 0.1):
    """Fixed-iteration point-to-plane ICP on one pyramid level. Returns
    (T, (n_corr (iters,), err (iters,)))."""
    T = T0
    ncs, errs = [], []
    for _ in range(iters):
        A, b, n_corr, err = build_system(T, src, dst, intr, dist_thresh)
        dx = _solve6(A, b)
        ok = (n_corr > 30) & torch.all(torch.isfinite(dx))
        dx = torch.where(ok, dx, 0.0)
        T = se3.exp_se3(dx) @ T
        ncs.append(n_corr)
        errs.append(err)
    return T, (torch.stack(ncs), torch.stack(errs))


def estimate_transform(src_pyr, dst_pyr, intr: torch.Tensor, iterations=(10, 5, 4), dist_thresh: float = 0.1):
    """Multiscale ICP, coarse -> fine. iterations[l] applies to pyramid
    level l (0 = finest), run coarsest first. Returns (T src->dst, success,
    residual), all device tensors."""
    levels = len(src_pyr)
    T = torch.eye(4, dtype=torch.float32, device=intr.device)
    n_corr = err = None
    for l in reversed(range(levels)):
        T, (ncs, errs) = icp_level(T, src_pyr[l], dst_pyr[l], level_intrinsics(intr, l),
                                   iters=iterations[min(l, len(iterations) - 1)],
                                   dist_thresh=dist_thresh * (1 << l))
        n_corr, err = ncs[-1], errs[-1]
    success = (n_corr > 100) & (err < 0.05)
    return T, success, err
