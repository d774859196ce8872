"""Batched RANSAC — the port of opencv_contrib_tpu/mvg/robust.py.

All hypotheses are drawn up front and solved and scored as one batched
computation (hypotheses x points), with masked sampling for padded inputs.
The draws come from an explicit `torch.Generator` on the data's device;
`ransac` looks `sample_indices` up in this module at each call, so a caller
can replay draws made elsewhere by replacing it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from opencv_contrib_tpu_torch.mvg import fundamental, homography, resection


class RansacResult(NamedTuple):
    model: torch.Tensor
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # scalar int
    score: torch.Tensor  # scalar float (inlier count or MSAC score)
    best_index: torch.Tensor


def sample_indices(generator: torch.Generator, n_points: int, mask: torch.Tensor, n_hypotheses: int,
                   sample_size: int) -> torch.Tensor:
    """Draw (n_hypotheses, sample_size) distinct valid indices: the largest
    of uniform keys over the valid points, one batched top-k and no rejection
    loop (the Gumbel top-k of the JAX package; a monotone map of the keys
    picks the same indices)."""
    u = torch.rand((n_hypotheses, n_points), generator=generator, device=mask.device)
    u = torch.where(mask[None, :], u, torch.full_like(u, -torch.inf))
    return torch.topk(u, sample_size, dim=1).indices


def ransac(
    generator: torch.Generator,
    solver: Callable,
    scorer: Callable,
    data,
    n_points: int,
    sample_size: int,
    n_hypotheses: int = 256,
    threshold: float = 1e-2,
    mask: torch.Tensor | None = None,
    msac: bool = True,
) -> RansacResult:
    """Generic batched RANSAC.

    solver(*samples) -> (models (H, M, ...), model_valid (H, M)) for H
        minimal samples (each data array indexed to (H, sample_size, ...));
        M models a sample (1 for 8-pt, 3 for 7-pt).
    scorer(models (K, ...), *data) -> residuals (K, N) for all points.
    data: tuple of tensors with leading dim N.
    The best model is the first of the highest scores.
    """
    if mask is None:
        mask = torch.ones(n_points, dtype=torch.bool, device=data[0].device)
    idx = sample_indices(generator, n_points, mask, n_hypotheses, sample_size)
    models, model_valid = solver(*(d[idx] for d in data))
    flat_models = models.reshape((-1,) + models.shape[2:])
    flat_valid = model_valid.reshape(-1)
    res = scorer(flat_models, *data)  # (K, N)
    inl = (res < threshold) & mask
    if msac:
        scores = torch.sum(torch.where(inl, threshold - res, torch.zeros_like(res)), dim=-1)
    else:
        scores = torch.sum(inl, dim=-1).to(torch.float32)
    scores = torch.where(flat_valid, scores, torch.full_like(scores, -torch.inf))
    # indexing by a (1,) tensor gathers on the device; a 0-d index would
    # read it back to the host
    best = torch.argmax(scores, dim=0, keepdim=True)
    inliers = inl[best][0]
    return RansacResult(flat_models[best][0], inliers, torch.sum(inliers), scores[best][0], best[0])


# ----------------------------------------------------------------------------
# The robust estimators of the reference's public API
# ----------------------------------------------------------------------------


def _one_model(model: torch.Tensor):
    return model[:, None], torch.ones(model.shape[:1] + (1,), dtype=torch.bool, device=model.device)


def fundamental_8pt_robust(generator, x1, x2, threshold_px: float = 1.0, mask=None, n_hypotheses: int = 256):
    """RANSAC 8-point fundamental; threshold_px is in pixels on the symmetric
    epipolar distance."""
    return ransac(
        generator, lambda s1, s2: _one_model(fundamental.eight_point(s1, s2)), fundamental.epipolar_distance,
        (x1, x2), x1.shape[0], 8, n_hypotheses=n_hypotheses, threshold=threshold_px ** 2, mask=mask,
    )


def fundamental_7pt_robust(generator, x1, x2, threshold_px: float = 1.0, mask=None, n_hypotheses: int = 128):
    """RANSAC 7-point fundamental (up to 3 models a sample)."""
    return ransac(
        generator, fundamental.seven_point, fundamental.epipolar_distance,
        (x1, x2), x1.shape[0], 7, n_hypotheses=n_hypotheses, threshold=threshold_px ** 2, mask=mask,
    )


def homography_robust(generator, x1, x2, threshold_px: float = 2.0, mask=None, n_hypotheses: int = 256):
    return ransac(
        generator, lambda s1, s2: _one_model(homography.dlt(s1, s2)), homography.transfer_error,
        (x1, x2), x1.shape[0], 4, n_hypotheses=n_hypotheses, threshold=threshold_px ** 2, mask=mask,
    )


def _pnp_solver(sX, sx):
    R, t = resection.pnp_dlt(sX, sx)
    return _one_model(torch.cat([R, t[..., None]], dim=-1))


def _pnp_scorer(Rt, X, xn):
    """Squared calibrated reprojection error of (K, 3, 4) poses, inf behind
    the camera: (K, N)."""
    Xc = torch.einsum("kij,nj->kni", Rt[..., :3], X) + Rt[:, None, :, 3]
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    d = torch.sum((Xc[..., :2] / zs[..., None] - xn) ** 2, dim=-1)
    return torch.where(z <= 0, torch.full_like(d, torch.inf), d)


def pnp_robust(generator, X, xn, threshold: float = 0.01, mask=None, n_hypotheses: int = 256):
    """RANSAC PnP on calibrated correspondences (robust EuclideanResect):
    the model is [R | t] (3, 4)."""
    return ransac(
        generator, _pnp_solver, _pnp_scorer, (X, xn), X.shape[0], 6,
        n_hypotheses=n_hypotheses, threshold=threshold ** 2, mask=mask,
    )
