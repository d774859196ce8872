"""Shape module completion: EMD costs and the affine transformer (the port
of opencv_contrib_tpu/shape/extra.py).

Reference anchors (shape):
- include/opencv2/shape/hist_cost.hpp — EMDHistogramCostExtractor,
  EMDL1HistogramCostExtractor (+ emdL1.cpp, the tree-EMD for histograms)
- include/opencv2/shape/shape_transformer.hpp — AffineTransformer
  (estimateTransformation / applyTransformation / transformCost)

1D EMD is exactly the L1 distance of CDFs (one cumsum); the 2D/grid EMD-L1
and general-cost EMD between weighted point sets are Sinkhorn-regularized
OT with a fixed iteration count: a loop on the device with no host read.
The pairwise grid costs run every pair's Sinkhorn at once (the twin's
nested vmap). Products run in full f32.
"""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


def emd_1d(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Exact 1D earth mover's distance between histograms with unit ground
    distance: L1 norm of the CDF difference (after mass normalization).
    Leading dimensions are batches."""
    a = h1 / torch.clamp(h1.sum(-1, keepdim=True), min=1e-12)
    b = h2 / torch.clamp(h2.sum(-1, keepdim=True), min=1e-12)
    return torch.abs(torch.cumsum(a - b, dim=-1)).sum(-1)


def _grid_cost(nr: int, na: int, device) -> torch.Tensor:
    ys = torch.arange(nr, device=device)[:, None].expand(nr, na).reshape(-1).to(torch.float32)
    xs = torch.arange(na, device=device)[None, :].expand(nr, na).reshape(-1).to(torch.float32)
    return torch.abs(ys[:, None] - ys[None, :]) + torch.abs(xs[:, None] - xs[None, :])


def _sinkhorn(a, b, K, C, n_iters: int):
    """Transport cost of Sinkhorn's plan between a (..., n) and b (..., m)
    under the Gibbs kernel K (n, m) of cost C, n_iters iterations."""
    u, v = torch.ones_like(a), torch.ones_like(b)
    with f32_matmul_precision():
        for _ in range(n_iters):
            u = a / torch.clamp(v @ K.T, min=1e-30)
            v = b / torch.clamp(u @ K, min=1e-30)
    P = u[..., :, None] * K * v[..., None, :]
    return (P * C).sum((-2, -1))


def emd_l1_grid(h1: torch.Tensor, h2: torch.Tensor, reg: float = 0.02, n_iters: int = 300) -> torch.Tensor:
    """EMD-L1 between 2D histograms (parity: cv::EMDL1, emdL1.cpp — the
    shape-context log-polar grids are 2D histograms). The reference solves
    the tree-flow LP; here the L1-ground-metric transport is solved by
    entropic Sinkhorn with a small regularizer — dense (bins x bins)
    products, near-exact for the sharp regularization used. h1, h2 (...,
    nr, na): leading dimensions are batches."""
    nr, na = h1.shape[-2:]
    a = h1.reshape(*h1.shape[:-2], -1)
    b = h2.reshape(*h2.shape[:-2], -1)
    a = a / torch.clamp(a.sum(-1, keepdim=True), min=1e-12)
    b = b / torch.clamp(b.sum(-1, keepdim=True), min=1e-12)
    C = _grid_cost(nr, na, h1.device)
    scale = torch.clamp(C.max(), min=1e-9)
    K = torch.exp(-C / (reg * scale))
    return _sinkhorn(a, b, K, C, n_iters)


def emd_sinkhorn(w1: torch.Tensor, x1: torch.Tensor, w2: torch.Tensor, x2: torch.Tensor,
                 reg: float = 0.05, n_iters: int = 200) -> torch.Tensor:
    """General EMD between weighted point sets (parity: cv::EMD with
    DIST_L2 ground metric), via entropic-regularized Sinkhorn iterations —
    dense products + row/col renormalizations. w: (N,), x: (N, D). Returns
    the transport cost."""
    a = w1 / torch.clamp(w1.sum(), min=1e-12)
    b = w2 / torch.clamp(w2.sum(), min=1e-12)
    with f32_matmul_precision():
        C = torch.sqrt(torch.clamp((x1 ** 2).sum(1)[:, None] + (x2 ** 2).sum(1)[None, :] - 2.0 * x1 @ x2.T, min=0.0))
    scale = torch.clamp(C.max(), min=1e-9)
    # clamp the Gibbs kernel away from float32 underflow (sharp reg)
    K = torch.clamp(torch.exp(-C / (reg * scale)), min=1e-30)
    return _sinkhorn(a, b, K, C, n_iters)


def emd_histogram_cost(descs1: torch.Tensor, descs2: torch.Tensor, grid_shape=None) -> torch.Tensor:
    """Pairwise EMD-L1 cost matrix between two stacks of histograms
    (parity: EMDL1HistogramCostExtractor::buildCostMatrix). descs: (N, D)
    flattened histograms; grid_shape optionally reinterprets D as 2D. Every
    pair at once."""
    N, M = descs1.shape[0], descs2.shape[0]
    a = descs1[:, None].expand(N, M, -1)
    b = descs2[None].expand(N, M, -1)
    if grid_shape is None:
        return emd_1d(a, b)
    nr, na = grid_shape
    return emd_l1_grid(a.reshape(N, M, nr, na), b.reshape(N, M, nr, na))


# ---------------------------------------------------------------------------
# Affine transformer
# ---------------------------------------------------------------------------


def affine_fit(src: torch.Tensor, dst: torch.Tensor, full_affine: bool = True):
    """Estimate the 2x3 affine mapping src -> dst from correspondences
    (parity: cv::AffineTransformer::estimateTransformation). With
    full_affine=False restricts to similarity (scale+rotation+translation),
    matched to estimateRigidTransform(false). The full fit is a least-squares
    solve by QR (`lstsq(driver="gels")`, the driver the card offers)."""
    if full_affine:
        N = src.shape[0]
        A = torch.cat([src, torch.ones((N, 1), dtype=src.dtype, device=src.device)], 1)  # (N, 3)
        with f32_matmul_precision():
            sol = torch.linalg.lstsq(A, dst, driver="gels").solution  # (3, 2)
        return sol.T  # (2, 3)

    # similarity-constrained closed form (Umeyama without reflection)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    a = (sc * dc).sum() / torch.clamp((sc ** 2).sum(), min=1e-12)
    bnum = (sc[:, 0] * dc[:, 1] - sc[:, 1] * dc[:, 0]).sum()
    b = bnum / torch.clamp((sc ** 2).sum(), min=1e-12)
    R = torch.stack([torch.stack([a, -b]), torch.stack([b, a])])
    t = mu_d - R @ mu_s
    return torch.cat([R, t[:, None]], 1)


def affine_apply(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 2x3 affine to (N, 2) points (applyTransformation)."""
    with f32_matmul_precision():
        return pts @ M[:, :2].T + M[:, 2]


def affine_transform_cost(M: torch.Tensor) -> torch.Tensor:
    """Bending-energy-style cost of an affine map (transformCost): the
    deviation of the linear part from a pure rotation+uniform scale."""
    A = M[:, :2]
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    s = torch.sqrt(torch.clamp(torch.abs(det), min=1e-12))
    E = A / s
    with f32_matmul_precision():
        EE = E @ E.T
    return torch.linalg.matrix_norm(EE - torch.eye(2, device=M.device)) + torch.abs(torch.log(s))
