"""MIL tracker: online multiple-instance boosting over Haar-like features
(the port of opencv_contrib_tpu/tracking/mil.py).

Reference anchors: tracking/src/trackerMIL.cpp + trackerMILModel.cpp and the
Haar feature bank in tracking/src/feature.cpp: a pool of random
two-rectangle Haar responses; weak classifiers are online Gaussian
posteriors; the K most discriminative weak learners score the candidates.

Each set of patches (the 289 candidates; the 16 positives and 32
negatives of a step, one set) gets its summed-area tables from one batched
call of `ops.integral.integral`: one launch of the integral kernel for all
of them on the card, 2 a step, 1 at init. The random offsets come from a
`torch.Generator` on the image's device; nothing is read back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.ops.integral import integral
from opencv_contrib_tpu_torch.tracking.correlation import _vec

BANK_KEYS = ("y0", "x0", "y1", "x1", "w")


def make_feature_bank(gen: torch.Generator, patch: int = 32, n_features: int = 250):
    """Random two-rectangle Haar bank (feature.cpp CvHaarEvaluator), drawn
    from `gen` on its device: {"y0", "x0", "y1", "x1"} (n_features, 2) int
    corners of each feature's two rectangles in patch coordinates and "w"
    (n_features, 2) float32 weights (+1, -1)."""
    dev = gen.device
    y0 = torch.randint(0, patch - 4, (n_features, 2), generator=gen, device=dev)
    x0 = torch.randint(0, patch - 4, (n_features, 2), generator=gen, device=dev)
    hw = torch.randint(2, patch // 2, (n_features, 2, 2), generator=gen, device=dev)
    y1 = torch.clamp(y0 + hw[..., 0], max=patch - 1)
    x1 = torch.clamp(x0 + hw[..., 1], max=patch - 1)
    weights = torch.stack([torch.ones(n_features, device=dev), -torch.ones(n_features, device=dev)], dim=1)
    return {"y0": y0, "x0": x0, "y1": y1, "x1": x1, "w": weights}


def _haar_responses(patches, bank):
    """patches (N, P, P) -> (N, F) box-sum differences, from the N padded
    summed-area tables of one `integral` call."""
    N, P = patches.shape[0], patches.shape[-1]
    ii = integral(patches).reshape(N, -1)  # (N, (P+1)^2)
    y0, x0, y1, x1 = (bank[k].long() for k in ("y0", "x0", "y1", "x1"))

    def corner(y, x):
        return ii[:, (y * (P + 1) + x).reshape(-1)].reshape(N, *y.shape)

    s = corner(y1 + 1, x1 + 1) - corner(y0, x1 + 1) - corner(y1 + 1, x0) + corner(y0, x0)  # (N, F, 2)
    area = (y1 - y0 + 1) * (x1 - x0 + 1)
    return (s / area * bank["w"]).sum(-1)


class MilState(NamedTuple):
    center: torch.Tensor  # (2,)
    mu_pos: torch.Tensor  # (F,) weak classifier Gaussian means (positive)
    sig_pos: torch.Tensor
    mu_neg: torch.Tensor
    sig_neg: torch.Tensor


def _extract(img, centers, patch):
    dev = img.device
    o = torch.arange(patch, dtype=torch.float32, device=dev) - patch / 2 + 0.5
    y = centers[:, 0:1, None] + o[None, :, None]
    x = centers[:, 1:2, None] + o[None, None, :]
    return sample_bilinear(img, y * torch.ones((1, 1, patch), device=dev), x * torch.ones((1, patch, 1), device=dev))


def _loglik(f, mu, sig):
    return -0.5 * ((f - mu) / sig) ** 2 - torch.log(sig)


def _classifier_scores(feats, state: MilState, sel=None):
    """Per-patch score: the sum over the (selected) weak learners of
    log p(f|pos) - log p(f|neg)."""
    ll = _loglik(feats, state.mu_pos, state.sig_pos) - _loglik(feats, state.mu_neg, state.sig_neg)
    if sel is not None:
        ll = ll * sel[None]
    return ll.sum(-1)


def _sample_offsets(gen: torch.Generator, n, radius, min_radius=0.0):
    """n offsets uniform over the ring min_radius..radius (area-uniform),
    (n, 2) (dy, dx), drawn from `gen` on its device."""
    dev = gen.device
    a = torch.rand(n, generator=gen, device=dev) * (2 * math.pi)
    lo = (min_radius / max(radius, 1e-6)) ** 2
    r = torch.sqrt(lo + (1.0 - lo) * torch.rand(n, generator=gen, device=dev)) * radius
    return torch.stack([r * torch.sin(a), r * torch.cos(a)], dim=1)


def _grid_offsets(radius: float, step: float, device=None):
    """The dense candidate grid (trackerMILModel samples the search region
    exhaustively on the image grid)."""
    o = torch.arange(-radius, radius + 1e-6, step, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(o, o, indexing="ij")
    return torch.stack([dy.reshape(-1), dx.reshape(-1)], dim=1)


def _stable_top_k(x, k):
    """The indices of the k largest entries, the lower index first at a tie
    (`lax.top_k`'s order): a stable descending sort."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _update_gaussians(mu, sig, f, lr):
    """The running class Gaussian of each weak learner (population std, as
    the twin's ddof 0)."""
    m, s = f.mean(0), f.std(0, correction=0) + 1e-3
    return (1 - lr) * mu + lr * m, torch.sqrt((1 - lr) * sig ** 2 + lr * s ** 2) + 1e-4


def _bags(img, gen, center, bank, patch, n_pos, n_neg):
    """The positive and negative bags' features around `center`, both bags'
    patches in one `_haar_responses` call."""
    pos = center[None] + _sample_offsets(gen, n_pos, 3.0)
    neg = center[None] + _sample_offsets(gen, n_neg, 40.0, min_radius=12.0)
    f = _haar_responses(_extract(img, torch.cat([pos, neg]), patch), bank)
    return f[:n_pos], f[n_pos:]


def mil_init(img, center_yx, gen: torch.Generator, bank, patch: int = 32) -> MilState:
    """Train the weak-classifier pool at the given position (no detection
    pass: the classifier is untrained at init)."""
    dev = img.device
    center = _vec(center_yx, dev)
    F = bank["y0"].shape[0]
    st = MilState(center, torch.zeros(F, device=dev), torch.ones(F, device=dev), torch.zeros(F, device=dev),
                  torch.ones(F, device=dev))
    return _mil_train(st, img, gen, bank, patch, 16, 32, 1.0)


def _mil_train(state, img, gen, bank, patch, n_pos, n_neg, lr):
    f_pos, f_neg = _bags(img, gen, state.center, bank, patch, n_pos, n_neg)
    mu_p, sig_p = _update_gaussians(state.mu_pos, state.sig_pos, f_pos, lr)
    mu_n, sig_n = _update_gaussians(state.mu_neg, state.sig_neg, f_neg, lr)
    return MilState(state.center, mu_p, sig_p, mu_n, sig_n)


def mil_update(state: MilState, img, gen: torch.Generator, bank, patch: int = 32, n_pos: int = 16,
               n_neg: int = 32, search_radius: float = 8.0, k_sel: int = 50, lr: float = 0.15):
    """One MIL tracking step. Returns (new_state, best_score)."""
    return _mil_step_dyn(state, img, gen, bank, patch, n_pos, n_neg, search_radius, k_sel, lr)


def _mil_step_dyn(state, img, gen, bank, patch, n_pos, n_neg, search_radius, k_sel, lr):
    cand = state.center[None] + _grid_offsets(search_radius, 1.0, img.device)
    feats_c = _haar_responses(_extract(img, cand, patch), bank)
    disc = torch.abs(state.mu_pos - state.mu_neg) / (state.sig_pos + state.sig_neg)
    top = _stable_top_k(disc, k_sel)
    sel = torch.zeros(disc.shape[0], device=img.device).index_fill(0, top, 1.0)
    scores = _classifier_scores(feats_c, state, sel)
    best = torch.argmax(scores).reshape(1)
    center = cand.index_select(0, best)[0]

    f_pos, f_neg = _bags(img, gen, center, bank, patch, n_pos, n_neg)
    mu_p, sig_p = _update_gaussians(state.mu_pos, state.sig_pos, f_pos, lr)
    mu_n, sig_n = _update_gaussians(state.mu_neg, state.sig_neg, f_neg, lr)
    return MilState(center, mu_p, sig_p, mu_n, sig_n), scores.index_select(0, best)[0]
