"""BRISQUE's learned stage, trained in the repository (the port of
opencv_contrib_tpu/quality/brisque_svr.py; quality/src/quality_brisque.cpp
computeFeatures and the SVM it evaluates).

The reference ships an SVM regression model trained on LIVE-IQA opinion
scores; here the same head is trained on synthetically distorted images:
graded Gaussian blur, white noise and JPEG-style 8x8 DCT quantisation of
procedurally generated naturalistic textures, with the severity as the
target (0 pristine .. 100 worst). Nothing is fetched.

The fixture generators (`natural_texture`, `distort`, `jpeg_blockiness`,
`gaussian_blur_np`) are host numpy, as in the JAX package, so a seed gives
both packages the same images. The 36 features come from the port's
`quality.brisque_features` on the caller's device (a tensor's own, or
`device` for numpy images, the card unless the caller asks for the CPU);
the model is an RBF kernel ridge regression
(the epsilon-SVR's function class with a closed-form fit; features
min/max-normalised to [-1, 1] as the reference's SVM scaling stage does),
fitted and evaluated in numpy on the host as the JAX package does it. The
npz of `save_model` is the JAX package's: either package loads the other's
model.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.quality.brisque import brisque_features
from opencv_contrib_tpu_torch.utils.device import resolve


class BrisqueModel(NamedTuple):
    X: np.ndarray  # (N, 36) normalized training features
    alpha: np.ndarray  # (N,) dual coefficients
    feat_lo: np.ndarray  # (36,)
    feat_hi: np.ndarray  # (36,)
    gamma: float


# ---------------------------------------------------------------------------
# synthetic distortions (host-side fixture generators)

_DCT8 = np.asarray([[np.cos((2 * j + 1) * i * np.pi / 16.0) *
                     (np.sqrt(0.125) if i == 0 else 0.5)
                     for j in range(8)] for i in range(8)], np.float64)

# JPEG Annex K luminance quantization table (ITU-T T.81 standard data)
_QTABLE = np.asarray([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float64)


def jpeg_blockiness(img: np.ndarray, quality: float) -> np.ndarray:
    """8x8 DCT quantization at a JPEG-style quality factor (1..100) —
    the blockiness distortion family."""
    h, w = img.shape
    h8, w8 = h - h % 8, w - w % 8
    x = np.asarray(img[:h8, :w8], np.float64) * 255.0 - 128.0
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    q = np.clip(np.floor((_QTABLE * scale + 50.0) / 100.0), 1, 255)
    b = x.reshape(h8 // 8, 8, w8 // 8, 8).transpose(0, 2, 1, 3)
    c = np.einsum("ij,bkjl,ml->bkim", _DCT8, b, _DCT8)
    c = np.round(c / q) * q
    r = np.einsum("ji,bkjl,lm->bkim", _DCT8, c, _DCT8)
    out = np.asarray(img, np.float64).copy()
    out[:h8, :w8] = (r.transpose(0, 2, 1, 3).reshape(h8, w8) + 128.0) / 255.0
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def gaussian_blur_np(img: np.ndarray, sigma: float) -> np.ndarray:
    r = max(1, int(3 * sigma))
    t = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    out = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), 0, img)
    out = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), 1, out)
    return out.astype(np.float32)


def natural_texture(rng, shape=(96, 96)) -> np.ndarray:
    """Procedural naturalistic image: 1/f-weighted multi-octave filtered
    noise + a few hard edges (the NSS statistics BRISQUE models hold for
    such spectra)."""
    h, w = shape
    img = np.zeros(shape, np.float32)
    for octave, sigma in enumerate((8.0, 4.0, 2.0, 1.0)):
        n = rng.standard_normal(shape).astype(np.float32)
        img += gaussian_blur_np(n, sigma) * (2.0 ** -octave) * 4.0
    # hard structure: a few random step edges
    for _ in range(3):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        th = rng.uniform(0, np.pi)
        yy, xx = np.mgrid[0:h, 0:w]
        mask = ((yy - y0) * np.sin(th) + (xx - x0) * np.cos(th)) > 0
        img += mask * rng.uniform(-0.5, 0.5)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return 0.1 + 0.8 * img


def distort(img: np.ndarray, kind: str, severity: int, rng) -> np.ndarray:
    """severity 0 (pristine) .. 4 (worst) for each distortion family."""
    if severity == 0:
        return img.astype(np.float32)
    if kind == "blur":
        return gaussian_blur_np(img, [0.0, 0.8, 1.6, 2.6, 4.0][severity])
    if kind == "noise":
        s = [0.0, 0.02, 0.05, 0.1, 0.18][severity]
        return np.clip(img + rng.standard_normal(img.shape) * s,
                       0, 1).astype(np.float32)
    if kind == "jpeg":
        return jpeg_blockiness(img, [100, 35, 15, 7, 3][severity])
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# training + scoring

def _features(img, device="cuda") -> np.ndarray:
    """The 36 BRISQUE features of (H, W) on its device (a tensor) or on
    `device` (an array), as float32 numpy."""
    x = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.asarray(img, np.float32)).to(resolve(device))
    return brisque_features(x.to(torch.float32)).cpu().numpy()


def train_brisque_model(n_images: int = 16, seed: int = 0, lam: float = 1e-3, device="cuda") -> BrisqueModel:
    """Train the regression head on graded synthetic distortions
    (quality/src/quality_brisque.cpp's computeFeatures -> SVM role); the
    features are taken on `device`."""
    rng = np.random.default_rng(seed)
    feats, ys = [], []
    for _ in range(n_images):
        base = natural_texture(rng)
        for kind in ("blur", "noise", "jpeg"):
            for sev in range(5):
                feats.append(_features(distort(base, kind, sev, rng), device))
                ys.append(25.0 * sev)
    X = np.stack(feats)
    y = np.asarray(ys, np.float64)
    lo, hi = X.min(0), X.max(0)
    Xn = 2.0 * (X - lo) / np.maximum(hi - lo, 1e-12) - 1.0
    # median-heuristic RBF bandwidth
    d2 = ((Xn[:, None] - Xn[None]) ** 2).sum(-1)
    gamma = 1.0 / max(np.median(d2[d2 > 0]), 1e-6)
    K = np.exp(-gamma * d2)
    alpha = np.linalg.solve(K + lam * np.eye(len(Xn)), y)
    return BrisqueModel(Xn.astype(np.float32), alpha.astype(np.float32), lo.astype(np.float32),
                        hi.astype(np.float32), float(gamma))


def score_features(model: BrisqueModel, f) -> float:
    """The trained score of a 36-feature vector (numpy or a tensor)."""
    f = f.detach().cpu().numpy() if isinstance(f, torch.Tensor) else np.asarray(f, np.float32)
    fn = 2.0 * (f - model.feat_lo) / np.maximum(model.feat_hi - model.feat_lo, 1e-12) - 1.0
    d2 = ((model.X - fn[None]) ** 2).sum(-1)
    return float(np.exp(-model.gamma * d2) @ model.alpha)


def brisque_score(model: BrisqueModel, img, device="cuda") -> float:
    """Trained BRISQUE score (0 good .. ~100 bad), the QualityBRISQUE::
    compute contract: the features of img on its device (a tensor) or on
    `device` (an array), the model on the host."""
    return score_features(model, _features(img, device))


def save_model(model: BrisqueModel, path: str) -> None:
    np.savez(path, **model._asdict())


def load_model(path: str) -> BrisqueModel:
    z = np.load(path)
    return BrisqueModel(z["X"], z["alpha"], z["feat_lo"], z["feat_hi"], float(z["gamma"]))
