"""Learning-based white balance (the port of opencv_contrib_tpu/xphoto/
learning_wb.py; xphoto/src/learning_based_color_balance.cpp).

The per-image features (average, brightest and dominant chromaticity, the
largest saturation) are computed on the image's device; the regressor is a
linear model over them, fitted in closed form (`fit_wb_model`, float64 on
the host, as the JAX package solves it) in place of the reference's
offline-trained tree ensemble. `interop.wb_model` carries a model from one
package to the other."""

from __future__ import annotations

import numpy as np
import torch


def wb_features(img, sat_thresh: float = 0.98, nbins: int = 16) -> torch.Tensor:
    """Illuminant-estimation features of (H, W, 3) RGB in [0, 1]: (8,) with
    [avg chroma (2), brightest chroma (2), dominant chroma (2), max-sat (1),
    1]."""
    img = img if isinstance(img, torch.Tensor) else torch.as_tensor(np.asarray(img, np.float32))
    flat = img.to(torch.float32).reshape(-1, 3)
    s = flat.sum(-1)
    mx, mn = flat.max(-1).values, flat.min(-1).values
    ok = (mx < sat_thresh) & (s > 1e-3)
    w = ok.to(torch.float32)

    avg = (flat * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1)
    avg_c = avg[:2] / torch.clamp(avg.sum(), min=1e-6)

    bright_i = torch.argmax(torch.where(ok, s, -1.0))
    b = flat[bright_i]
    bright_c = b[:2] / torch.clamp(b.sum(), min=1e-6)

    # dominant colour: the fullest bin of a joint (r/s, g/s) chromaticity histogram (counts of
    # ones: exact in any order of the sum)
    inv = torch.clamp(s, min=1e-6)
    r_c = torch.clamp((flat[:, 0] / inv * nbins).to(torch.int32), 0, nbins - 1)
    g_c = torch.clamp((flat[:, 1] / inv * nbins).to(torch.int32), 0, nbins - 1)
    hist = torch.zeros(nbins * nbins, dtype=torch.float32, device=flat.device)
    hist.index_add_(0, (r_c * nbins + g_c).to(torch.int64), w)
    dom = torch.argmax(hist)
    dom_c = torch.stack([(dom // nbins + 0.5) / nbins, (dom % nbins + 0.5) / nbins]).to(torch.float32)

    max_sat = torch.max(torch.where(ok, mx - mn, 0.0))
    one = torch.ones(1, dtype=torch.float32, device=flat.device)
    return torch.cat([avg_c, bright_c, dom_c, max_sat[None], one])


def fit_wb_model(imgs, illuminants, ridge: float = 1e-3) -> torch.Tensor:
    """Ridge-fit the linear feature -> illuminant-chromaticity regressor from
    (image, illuminant RGB) pairs: an (F, 2) float32 tensor on the CPU."""
    X = np.stack([wb_features(im).cpu().numpy() for im in imgs])
    L = np.asarray(illuminants, np.float32)
    y = L[:, :2] / np.maximum(L.sum(1, keepdims=True), 1e-6)
    W = np.linalg.solve(X.T @ X + ridge * np.eye(X.shape[1]), X.T @ y)
    return torch.from_numpy(W.astype(np.float32))


def learning_wb(img, model):
    """Estimate the illuminant with the learned regressor and correct the
    image (balanceWhite of LearningBasedWB): (balanced (H, W, 3), the
    illuminant (3,))."""
    img = img if isinstance(img, torch.Tensor) else torch.as_tensor(np.asarray(img, np.float32))
    img = img.to(torch.float32)
    f = wb_features(img)
    model = torch.as_tensor(model, dtype=torch.float32).to(img.device)
    chroma = torch.clamp(f @ model, 0.05, 0.9)  # (r, g) of the illuminant
    ill = torch.cat([chroma, (1.0 - chroma.sum())[None]])
    gains = ill.mean() / torch.clamp(ill, min=1e-6)
    return torch.clamp(img * gains, 0.0, 1.0), ill
