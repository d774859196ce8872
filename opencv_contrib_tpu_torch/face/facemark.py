"""Facemark: facial landmark fitting by cascaded shape regression (LBF/
Kazemi class; the port of opencv_contrib_tpu/face/facemark.py).

Reference anchors: face/src/facemarkLBF.cpp (FacemarkLBF: local binary
features from random-forest leaf codes + global linear regression per
cascade stage) and face/src/face_alignment.cpp (FacemarkKazemi: cascaded
gradient-boosted regression on pixel-difference features).

Each cascade stage samples pixel-difference features around all current
landmarks in one batched gather and applies a dense linear regressor;
`train` solves each stage by ridge regression on the host (numpy), its
features taken by this module's torch function on the CPU, as the twin's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.utils.device import as_float, constant
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


class FacemarkModel(NamedTuple):
    mean_shape: torch.Tensor  # (L, 2) in [0, 1]^2 box coords
    offsets: torch.Tensor  # (S, F, 2) feature point offsets per stage (box units)
    pairs: torch.Tensor  # (S, P, 2) int index pairs into the F feature points
    W: torch.Tensor  # (S, P, L*2) stage regressors
    b: torch.Tensor  # (S, L*2)


def _stage_features(img, shape_px, offsets, pairs, box_size):
    """Pixel-difference features indexed relative to the current shape:
    sample F points around each landmark's nearest anchor, difference the
    P pairs (the LBF/Kazemi feature construction)."""
    L = shape_px.shape[0]
    F = offsets.shape[0]
    anchor = shape_px[torch.arange(F, device=shape_px.device) % L]  # cycle anchors over landmarks
    pts = anchor + offsets * box_size  # (F, 2) (y, x)
    vals = sample_bilinear(img, pts[:, 0], pts[:, 1])  # (F,)
    pairs = pairs.long()
    return vals[pairs[:, 0]] - vals[pairs[:, 1]]  # (P,)


def fit(model: FacemarkModel, img, box):
    """Fit landmarks inside box (y0, x0, size), a (3,) tensor on the image's
    device. Returns (L, 2) pixel coords. Cascade: shape += W @
    features(shape) per stage (FacemarkLBF::fitImpl / Kazemi predict)."""
    img = as_float(img)
    y0, x0, bs = box[0], box[1], box[2]
    shape = model.mean_shape * bs + torch.stack([y0, x0])  # (L, 2)
    for s in range(model.offsets.shape[0]):
        f = _stage_features(img, shape, model.offsets[s], model.pairs[s], bs)
        with f32_matmul_precision():
            delta = (f @ model.W[s] + model.b[s]).reshape(-1, 2)
        shape = shape + delta * bs
    return shape


def train(images, shapes, boxes, n_stages: int = 3, n_feature_pts: int = 64,
          n_pairs: int = 128, ridge: float = 1.0, seed: int = 0) -> FacemarkModel:
    """Train the cascade by sequential ridge regression (the reference's
    per-stage global linear regression, facemarkLBF.cpp GlobalRegression).
    images: list of (H, W); shapes: (N, L, 2) pixel coords; boxes (N, 3).
    The model comes back on the CPU."""
    rng = np.random.default_rng(seed)
    shapes = np.asarray(shapes, np.float32)
    boxes = np.asarray(boxes, np.float32)
    N, L, _ = shapes.shape
    # mean shape in box coords
    norm = (shapes - boxes[:, None, :2]) / boxes[:, None, 2:3]
    mean_shape = norm.mean(0)

    offsets_all, pairs_all, W_all, b_all = [], [], [], []
    cur = np.stack([mean_shape * b[2] + b[:2] for b in boxes])  # (N, L, 2)
    for s in range(n_stages):
        radius = 0.25 * (0.6 ** s)  # shrinking feature support per stage
        offsets = rng.uniform(-radius, radius, (n_feature_pts, 2)).astype(np.float32)
        pairs = rng.integers(0, n_feature_pts, (n_pairs, 2)).astype(np.int32)
        X = np.zeros((N, n_pairs), np.float32)
        for i in range(N):
            X[i] = _stage_features(as_float(images[i]), torch.from_numpy(cur[i].astype(np.float32)),
                                   torch.from_numpy(offsets), torch.from_numpy(pairs),
                                   torch.tensor(boxes[i, 2])).numpy()
        Y = ((shapes - cur) / boxes[:, None, 2:3]).reshape(N, -1)
        Xb = np.concatenate([X, np.ones((N, 1), np.float32)], 1)
        Wb = np.linalg.solve(Xb.T @ Xb + ridge * np.eye(n_pairs + 1), Xb.T @ Y)
        W, b = Wb[:-1], Wb[-1]
        cur = cur + ((X @ W + b).reshape(N, L, 2)) * boxes[:, None, 2:3]
        offsets_all.append(offsets)
        pairs_all.append(pairs)
        W_all.append(W)
        b_all.append(b)
    f32 = np.float32
    return FacemarkModel(constant(mean_shape, "cpu"), constant(np.stack(offsets_all), "cpu"),
                         constant(np.stack(pairs_all), "cpu", torch.int32),
                         constant(np.stack(W_all).astype(f32), "cpu"), constant(np.stack(b_all).astype(f32), "cpu"))
