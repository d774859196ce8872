"""Online-AdaBoost tracker (Grabner et al.), the tracking module's
TrackerBoosting (tracking/src/trackerBoosting.cpp + trackerBoostingModel.cpp
/ feature.cpp); the port of opencv_contrib_tpu/tracking/boosting.py.

A pool of Haar weak hypotheses (a running Gaussian per class, MIL's bank),
K selectors each choosing the pool member with the lowest
importance-weighted error; strong classifier = sum of alpha-weighted
selected stumps. The selector chain, the twin's `lax.scan`, is a Python
loop over K whose steps stay on the device (no host read); each updates the
error accumulators of every pool member at once. The Haar features are
MIL's: one batched integral launch for each set of patches, 2 a step (the
candidates, then both bags), 1 at init.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.tracking.correlation import _vec
from opencv_contrib_tpu_torch.tracking.mil import (
    _bags,
    _extract,
    _grid_offsets,
    _haar_responses,
    _loglik,
    _update_gaussians,
    make_feature_bank,
)

__all__ = ["make_feature_bank", "BoostState", "boosting_init", "boosting_update"]


class BoostState(NamedTuple):
    center: torch.Tensor   # (2,)
    mu_pos: torch.Tensor   # (F,) running class Gaussians (weak hypotheses)
    sig_pos: torch.Tensor
    mu_neg: torch.Tensor
    sig_neg: torch.Tensor
    lam_c: torch.Tensor    # (K, F) importance mass classified correctly
    lam_w: torch.Tensor    # (K, F) importance mass classified wrongly
    chosen: torch.Tensor   # (K,) selected pool member per selector
    alpha: torch.Tensor    # (K,) selector vote weights


def _stump(feats, st: BoostState):
    """Weak hypothesis decision per (sample, feature): +1 where the Gaussian
    log-likelihood favours the positive class, else -1."""
    ll = _loglik(feats, st.mu_pos, st.sig_pos) - _loglik(feats, st.mu_neg, st.sig_neg)
    return torch.where(ll > 0, 1.0, -1.0)


def _update(st: BoostState, f_pos, f_neg, lr):
    mu_p, sig_p = _update_gaussians(st.mu_pos, st.sig_pos, f_pos, lr)
    mu_n, sig_n = _update_gaussians(st.mu_neg, st.sig_neg, f_neg, lr)
    return st._replace(mu_pos=mu_p, sig_pos=sig_p, mu_neg=mu_n, sig_neg=sig_n)


def _boost_pass(st: BoostState, feats, labels):
    """One online-AdaBoost pass: the sample importances lambda propagate
    through the K selectors, each updating its error accumulators and
    choosing its best pool member, distinct from the earlier selectors'."""
    h = _stump(feats, st)  # (N, F) in {-1, +1}
    correct = (h == labels[:, None]).to(torch.float32)  # (N, F)
    lam = torch.ones(feats.shape[0], device=feats.device)
    used = torch.zeros(st.mu_pos.shape[0], device=feats.device)
    inf = torch.full((), float("inf"), device=feats.device)
    lam_c, lam_w, chosen, alpha = [], [], [], []
    correct64 = correct.to(torch.float64)
    for k in range(st.lam_c.shape[0]):
        lam64 = lam.to(torch.float64)
        # the importance sums in float64: a sum of at most a few hundred float32
        # importances is exact there, so pool members whose sums are equal
        # (the importances take few distinct values) tie exactly, in any
        # order, and the lower index wins, as in the twin
        lam_c_k = st.lam_c[k] + (lam64[:, None] * correct64).sum(0).to(torch.float32)
        lam_w_k = st.lam_w[k] + (lam64[:, None] * (1.0 - correct64)).sum(0).to(torch.float32)
        err = lam_w_k / torch.clamp(lam_c_k + lam_w_k, min=1e-9)  # (F,)
        m = torch.argmin(torch.where(used > 0, inf, err)).reshape(1)
        used = used.index_fill(0, m, 1.0)
        e = torch.clamp(err.index_select(0, m)[0], 1e-4, 0.5 - 1e-4)
        a = 0.5 * torch.log((1.0 - e) / e)
        ok = correct.index_select(1, m)[:, 0]
        lam = lam * torch.where(ok > 0, 1.0 / (2.0 * (1.0 - e)), 1.0 / (2.0 * e))
        lam = lam / torch.mean(lam)
        lam_c.append(lam_c_k)
        lam_w.append(lam_w_k)
        chosen.append(m[0])
        alpha.append(a)
    return st._replace(lam_c=torch.stack(lam_c), lam_w=torch.stack(lam_w), chosen=torch.stack(chosen).to(torch.int32),
                       alpha=torch.stack(alpha))


def _strong_scores(feats, st: BoostState):
    """The alpha-weighted votes of the selected stumps, summed in float64:
    K float32 alphas of +-1 votes (e clamped to [1e-4, 0.5 - 1e-4], so
    within 2**-13 and 2**3) add exactly there in any order, so candidates
    whose votes agree tie exactly on every device and the lower index wins;
    rounded to float32, the twin's dtype."""
    h = _stump(feats, st)  # (N, F)
    hk = h.index_select(1, st.chosen.long())  # (N, K)
    return (hk.to(torch.float64) @ st.alpha.to(torch.float64)).to(torch.float32)  # (N,)


def _train_on_bags(st: BoostState, img, gen, bank, patch, lr):
    f_pos, f_neg = _bags(img, gen, st.center, bank, patch, 16, 32)
    st = _update(st, f_pos, f_neg, lr)
    feats = torch.cat([f_pos, f_neg], dim=0)
    labels = torch.cat([torch.ones(f_pos.shape[0], device=img.device), -torch.ones(f_neg.shape[0], device=img.device)])
    return _boost_pass(st, feats, labels)


def boosting_init(img, center_yx, gen: torch.Generator, bank, patch: int = 32, n_selectors: int = 50) -> BoostState:
    dev = img.device
    center = _vec(center_yx, dev)
    F = bank["y0"].shape[0]
    st = BoostState(center, torch.zeros(F, device=dev), torch.ones(F, device=dev), torch.zeros(F, device=dev),
                    torch.ones(F, device=dev), torch.full((n_selectors, F), 1e-2, device=dev),
                    torch.full((n_selectors, F), 1e-2, device=dev),
                    torch.zeros(n_selectors, dtype=torch.int32, device=dev), torch.zeros(n_selectors, device=dev))
    return _train_on_bags(st, img, gen, bank, patch, 0.5)


def boosting_update(st: BoostState, img, gen: torch.Generator, bank, patch: int = 32, search_radius: float = 10.0,
                    lr: float = 0.2):
    """One Boosting tracking step. Returns (new_state, best_score)."""
    cand = st.center[None] + _grid_offsets(search_radius, 1.0, img.device)
    feats_c = _haar_responses(_extract(img, cand, patch), bank)
    scores = _strong_scores(feats_c, st)
    best = torch.argmax(scores).reshape(1)
    st = st._replace(center=cand.index_select(0, best)[0])
    return _train_on_bags(st, img, gen, bank, patch, lr), scores.index_select(0, best)[0]
