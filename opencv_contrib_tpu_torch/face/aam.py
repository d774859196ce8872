"""FacemarkAAM: Active Appearance Model landmark fitting (the port of
opencv_contrib_tpu/face/aam.py).

Reference anchor: face/src/facemarkAAM.cpp:45 (FacemarkAAM::Params, the
third facemark family next to LBF and Kazemi): statistical shape model
(Procrustes + PCA) + shape-normalized appearance model (warp to the mean
shape frame, texture PCA), fit by iteratively updating pose/shape
parameters from the appearance residual.

Design divergence (documented in the twin): the shape-normalized sampling
is a thin-plate-spline warp of a fixed GxG grid (`shape.tps`, one bilinear
gather), and the parameter update is the classic Cootes AAM learned linear
regression, a cascade of stages: `dq = R @ (texture residual)`.

`train` is host numpy as in the twin; its texture samples are taken by this
module's torch functions on the CPU, and the model comes back on the CPU.
`fit` loops over the cascade's stages on the image's device with no host
read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.shape.tps import tps_apply, tps_fit
from opencv_contrib_tpu_torch.utils.device import as_float, constant
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

GRID = 20  # texture sampling grid (GRID^2 texels)


class AAMModel(NamedTuple):
    mean_shape: torch.Tensor  # (L, 2) mean shape, centered, unit scale
    shape_basis: torch.Tensor  # (ks, L*2) shape PCA modes
    tex_mean: torch.Tensor  # (G*G,)
    tex_basis: torch.Tensor  # (ka, G*G) appearance PCA modes
    R: torch.Tensor  # (n_stages, 4 + ks, G*G) cascade of update regressors
    grid_mean: torch.Tensor  # (G*G, 2) sampling grid in mean-shape frame


def _procrustes_one(shape, ref):
    """Similarity-align shape (L, 2) to ref (L, 2)."""
    sc = shape - shape.mean(0)
    rc = ref - ref.mean(0)
    a = (sc * rc).sum()
    b = (sc[:, 0] * rc[:, 1] - sc[:, 1] * rc[:, 0]).sum()
    n = (sc ** 2).sum()
    ca, cb = a / n, b / n
    x, y = sc[:, 0], sc[:, 1]
    return torch.stack([ca * x - cb * y, cb * x + ca * y], dim=1)


def _shape_from_params(model: AAMModel, q):
    """q = [log_scale, theta, ty, tx, c...] -> shape in image pixels."""
    s = torch.exp(q[0])
    th = q[1]
    t = q[2:4]
    c = q[4:]
    with f32_matmul_precision():
        base = model.mean_shape.reshape(-1) + c @ model.shape_basis
        base = base.reshape(-1, 2)
        Rm = torch.stack([torch.stack([torch.cos(th), -torch.sin(th)]), torch.stack([torch.sin(th), torch.cos(th)])])
        return s * (base @ Rm.T) + t[None, :]


def _sample_texture(model: AAMModel, img, shape_px):
    """Shape-normalized texture: TPS-warp the mean-frame grid to the image
    through (mean_shape -> shape_px), one bilinear gather; photometric
    normalization like the reference's texture model."""
    params = tps_fit(model.mean_shape, shape_px)
    pts = tps_apply(params, model.mean_shape, model.grid_mean)  # (G*G, 2) y,x
    vals = sample_bilinear(img, pts[:, 0], pts[:, 1])
    return (vals - vals.mean()) / (vals.std(correction=0) + 1e-6)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def train(images, shapes, n_shape_modes: int = 6, n_tex_modes: int = 12,
          n_perturb: int = 24, seed: int = 0) -> AAMModel:
    """Train the AAM from (images, landmark shapes (L, 2) in pixels).

    Mirrors FacemarkAAM training (facemarkAAM.cpp training_impl): Procrustes
    + shape PCA, shape-normalized texture PCA, then the update regressor R
    from synthetic perturbations (the classic AAM 'learn dR' step)."""
    rng = np.random.default_rng(seed)
    shapes = [np.asarray(s, np.float32) for s in shapes]

    # Procrustes iteration to the mean
    ref = shapes[0] - shapes[0].mean(0)
    ref = ref / np.linalg.norm(ref)
    for _ in range(3):
        aligned = [_procrustes_one(_t(s), _t(ref)).numpy() for s in shapes]
        ref = np.mean(aligned, axis=0)
        ref = ref / np.linalg.norm(ref)
    aligned = np.stack(aligned)  # (N, L, 2)
    mean_shape = ref.astype(np.float32)

    # shape PCA
    X = (aligned - mean_shape[None]).reshape(len(shapes), -1)
    _, _, Vt = np.linalg.svd(X, full_matrices=False)
    ks = min(n_shape_modes, Vt.shape[0])
    shape_basis = Vt[:ks].astype(np.float32)

    # mean-frame sampling grid over the mean shape's bounding box (pad 10%)
    lo = mean_shape.min(0) - 0.1 * (mean_shape.max(0) - mean_shape.min(0))
    hi = mean_shape.max(0) + 0.1 * (mean_shape.max(0) - mean_shape.min(0))
    gy = np.linspace(lo[0], hi[0], GRID)
    gx = np.linspace(lo[1], hi[1], GRID)
    grid = np.stack(np.meshgrid(gy, gx, indexing="ij"), axis=-1).reshape(-1, 2)

    model0 = AAMModel(_t(mean_shape), _t(shape_basis), torch.zeros(GRID * GRID), torch.zeros((1, GRID * GRID)),
                      torch.zeros((1, GRID * GRID)), _t(grid))

    tex = np.stack([_sample_texture(model0, as_float(img), _t(s)).numpy() for img, s in zip(images, shapes)])
    tex_mean = tex.mean(0).astype(np.float32)
    Xt = tex - tex_mean[None]
    _, _, Vt_t = np.linalg.svd(Xt, full_matrices=False)
    ka = min(n_tex_modes, Vt_t.shape[0])
    tex_basis = Vt_t[:ka].astype(np.float32)

    model1 = model0._replace(tex_mean=_t(tex_mean), tex_basis=_t(tex_basis))

    # ground-truth pose params per example (align mean to the example)
    def pose_of(s):
        c = s.mean(0)
        sc = s - c
        # similarity aligning mean_shape -> sc
        a = (mean_shape * sc).sum() / (mean_shape ** 2).sum()
        b = (mean_shape[:, 0] * sc[:, 1] - mean_shape[:, 1] * sc[:, 0]).sum() / (mean_shape ** 2).sum()
        scale = np.hypot(a, b)
        theta = np.arctan2(b, a)
        return np.array([np.log(scale), theta, c[0], c[1]], np.float32)

    # cascaded update-regressor training (supervised-descent flavored):
    # each stage is a ridge regression residual-texture -> dq, trained on
    # the error distribution LEFT by the previous stages
    n_stages = 4
    imgs_t = [as_float(im) for im in images]
    # training states start from BOX inits (the same init_params used at
    # fit time, box = landmark bbox + jitter) plus gaussian perturbations
    q_true, q_est = [], []
    for s in shapes:
        q0 = np.concatenate([pose_of(s), np.zeros(ks, np.float32)])
        scale0 = np.exp(q0[0])
        lo, hi = s.min(0), s.max(0)
        for p in range(n_perturb):
            if p % 2 == 0:
                jit = rng.normal(0, 0.05, 4)
                box = (lo[0] * (1 + jit[0]) - 0.05 * (hi[0] - lo[0]),
                       lo[1] * (1 + jit[1]) - 0.05 * (hi[1] - lo[1]),
                       (hi[0] - lo[0]) * (1.1 + jit[2]),
                       (hi[1] - lo[1]) * (1.1 + jit[3]))
                qe = init_params_from_box(mean_shape, ks, box).numpy().astype(np.float32)
            else:
                dq = np.concatenate([
                    rng.normal(0, [0.12, 0.08, 0.12 * scale0, 0.12 * scale0]),
                    rng.normal(0, 0.01 * scale0, ks),
                ]).astype(np.float32)
                qe = q0 + dq
            q_true.append(q0)
            q_est.append(qe)
    q_true = np.stack(q_true)
    q_est = np.stack(q_est)
    img_idx = np.repeat(np.arange(len(images)), n_perturb)

    def residual_at(img_t, q):
        shape_p = _shape_from_params(model1, _t(q))
        t = _sample_texture(model1, img_t, shape_p).numpy()
        r = t - tex_mean
        return r - tex_basis.T @ (tex_basis @ r)  # project out appearance

    R_stages = []
    for _ in range(n_stages):
        D = np.stack([residual_at(imgs_t[img_idx[m]], q_est[m]) for m in range(len(q_est))])
        Q = q_est - q_true  # current parameter errors
        lam = 1e-3 * np.trace(D.T @ D) / D.shape[1]
        Rm = np.linalg.solve(D.T @ D + lam * np.eye(D.shape[1]), D.T @ Q)
        R_stages.append(Rm.T.astype(np.float32))
        # apply this stage to the training states
        q_est = q_est - D @ Rm
    return model1._replace(R=_t(np.stack(R_stages)))


def init_params_from_box(mean_shape, ks, box, device="cpu"):
    """Initial q from a face box (y0, x0, h, w), a float32 tensor on
    `device`."""
    y0, x0, h, w = [float(v) for v in box]
    ms = mean_shape.detach().cpu().numpy() if isinstance(mean_shape, torch.Tensor) else np.asarray(mean_shape)
    span = (ms.max(0) - ms.min(0))
    scale = min(h / span[0], w / span[1]) * 0.9
    c = np.array([y0 + h / 2, x0 + w / 2], np.float32)
    return constant(np.concatenate([[np.log(scale), 0.0], c - scale * ms.mean(0), np.zeros(ks)]).astype(np.float32),
                    device)


def init_params(model: AAMModel, box):
    return init_params_from_box(model.mean_shape, model.shape_basis.shape[0], box, model.mean_shape.device)


def fit(model: AAMModel, img, q0, n_iters: int = 0):
    """Cascaded AAM fitting: each stage regressor consumes the project-out
    texture residual and updates the pose+shape parameters (the search loop
    of the classic AAM, staged). Returns (shape_px, q)."""
    img = as_float(img)
    q = q0
    for R_s in model.R:
        shape_px = _shape_from_params(model, q)
        t = _sample_texture(model, img, shape_px)
        with f32_matmul_precision():
            r = t - model.tex_mean
            r = r - model.tex_basis.T @ (model.tex_basis @ r)
            q = q - R_s @ r
    return _shape_from_params(model, q), q
