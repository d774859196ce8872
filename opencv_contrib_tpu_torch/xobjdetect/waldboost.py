"""WaldBoost detector over integral channel features (ICF) (the port of
opencv_contrib_tpu/xobjdetect/waldboost.py).

Reference anchors: xobjdetect/src/wbdetector.cpp (WBDetectorImpl::train /
detect), xobjdetect/src/waldboost.cpp (stump boosting + rejection
thresholds), ICF channels per Dollar et al. (gray + |grad| + 6 orientation
bins — the reference's feature_evaluator builds the same stack).

`window_features` builds the summed-area tables of all N_CH channels in one
call of `ops.integral.integral` on the (N_CH, H, W) stack, one launch of
the integral kernel on the card, and reads every box of every window in one
gather. Training is a host (numpy) loop over rounds, as in the twin;
detection evaluates the whole boosted cascade for every window at once,
with the Wald early-rejection thresholds as masks on the running score.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from opencv_contrib_tpu_torch.ops import filters
from opencv_contrib_tpu_torch.ops.integral import integral
from opencv_contrib_tpu_torch.utils.device import as_float, constant

N_ORIENT = 6
N_CH = N_ORIENT + 2  # orientations + gray + gradient magnitude


def icf_channels(img):
    """Integral-channel-feature stack (N_CH, H, W)."""
    gy, gx = filters.gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)  # [-pi, pi), orientation mod pi
    bin_f = torch.remainder(ang + math.pi, math.pi) / math.pi * N_ORIENT
    b = torch.clamp(bin_f.to(torch.int32), 0, N_ORIENT - 1)
    orient = (b[None] == torch.arange(N_ORIENT, device=img.device)[:, None, None]) * mag[None]
    return torch.cat([img[None], mag[None], orient], dim=0)


def make_feature_pool(gen: torch.Generator, win: int = 24, n_features: int = 512):
    """Random box features drawn from `gen` on its device: (channel, y0, x0,
    y1, x1) per feature, (F, 5) int64."""
    dev = gen.device

    def draw(lo, hi):
        return torch.randint(lo, hi, (n_features,), generator=gen, device=dev)

    ch, y0, x0, h, w = draw(0, N_CH), draw(0, win - 4), draw(0, win - 4), draw(2, win // 2), draw(2, win // 2)
    y1 = torch.clamp(y0 + h, max=win - 1)
    x1 = torch.clamp(x0 + w, max=win - 1)
    return torch.stack([ch, y0, x0, y1, x1], dim=1)  # (F, 5)


def window_features(img, centers_yx, pool, win: int = 24):
    """Evaluate every pool feature on every window: (N, F) responses. The
    N_CH tables come from one batched `integral` call; every box corner of
    every window is one gather from them (indices clipped to the table, as
    the twin clips them)."""
    chans = icf_channels(img)
    iis = integral(chans)  # (C, H+1, W+1)
    _, H, W = iis.shape
    flat = iis.reshape(-1)
    pool = pool.to(torch.int64)
    tl = centers_yx.to(torch.int64) - win // 2  # (N, 2) top-left
    c, y0, x0, y1, x1 = (pool[:, i] for i in range(5))
    ay = tl[:, :1] + y0[None]
    ax = tl[:, 1:] + x0[None]
    by = tl[:, :1] + y1[None]
    bx = tl[:, 1:] + x1[None]
    base = c[None] * (H * W)

    def at(y, x):
        return flat[base + torch.clamp(y, 0, H - 1) * W + torch.clamp(x, 0, W - 1)]

    s = at(by + 1, bx + 1) - at(ay, bx + 1) - at(by + 1, ax) + at(ay, ax)
    return s / ((y1 - y0 + 1) * (x1 - x0 + 1)).to(torch.int32)[None]


class WaldBoostModel(NamedTuple):
    pool: torch.Tensor  # (F, 5)
    feat_idx: torch.Tensor  # (T,) chosen feature per round
    thresh: torch.Tensor  # (T,)
    polarity: torch.Tensor  # (T,) +-1
    alpha: torch.Tensor  # (T,) stump weight
    reject: torch.Tensor  # (T,) Wald rejection threshold on the running score
    win: int


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def train(pos_feats, neg_feats, pool, n_rounds: int = 32, win: int = 24,
          reject_quantile: float = 0.02) -> WaldBoostModel:
    """AdaBoost stump training with per-round Wald rejection thresholds
    (waldboost.cpp: after each round the threshold is set so that
    ~reject_quantile of positives would be dropped). Host loop over rounds;
    each round's stump search is one vectorized numpy pass. The model's
    arrays go to the pool's device."""
    X = np.concatenate([_host(pos_feats), _host(neg_feats)])
    y = np.concatenate([np.ones(len(pos_feats)), -np.ones(len(neg_feats))])
    w = np.ones(len(y)) / len(y)
    feat_idx, thresh, polarity, alpha, reject = [], [], [], [], []
    run_score = np.zeros(len(y))
    # candidate thresholds per feature: quartiles of the data
    for _ in range(n_rounds):
        best = (1e9, 0, 0.0, 1.0)
        qs = np.quantile(X, [0.2, 0.35, 0.5, 0.65, 0.8], axis=0)  # (5, F)
        for qi in range(qs.shape[0]):
            pred = np.where(X > qs[qi][None, :], 1.0, -1.0)  # (N, F)
            err_pos = ((pred != y[:, None]) * w[:, None]).sum(0)  # polarity +1
            err_neg = 1.0 - err_pos
            e = np.minimum(err_pos, err_neg)
            j = int(np.argmin(e))
            if e[j] < best[0]:
                pol = 1.0 if err_pos[j] <= err_neg[j] else -1.0
                best = (e[j], j, qs[qi][j], pol)
        e, j, th, pol = best
        e = np.clip(e, 1.0 / (2 * len(y)), 1 - 1e-6)  # smooth: keeps alpha finite and diversifies features
        a = 0.5 * np.log((1 - e) / e)
        h = pol * np.where(X[:, j] > th, 1.0, -1.0)
        w = w * np.exp(-a * y * h)
        w /= w.sum()
        run_score += a * h
        # Wald rejection: keep reject_quantile of positives margin
        # margin must exceed float32 cumsum rounding at detection time
        rej = np.quantile(run_score[y > 0], reject_quantile) - max(1e-3, 1e-4 * abs(run_score).max())
        feat_idx.append(j)
        thresh.append(th)
        polarity.append(pol)
        alpha.append(a)
        reject.append(rej)
    dev = pool.device if isinstance(pool, torch.Tensor) else torch.device("cpu")
    return WaldBoostModel(
        torch.as_tensor(_host(pool)).to(dev), constant(feat_idx, dev, torch.int32), constant(thresh, dev),
        constant(polarity, dev), constant(alpha, dev), constant(reject, dev), win)


def _score_windows(feats, model: WaldBoostModel):
    """Boosted score with Wald early rejection as a mask over the running
    cumulative score (all stumps evaluated for all windows)."""
    x = feats[:, model.feat_idx.to(torch.int64)]  # (N, T)
    h = model.polarity[None] * torch.where(x > model.thresh[None], 1.0, -1.0)
    scores = torch.cumsum(model.alpha[None] * h, dim=1)  # (N, T)
    alive = torch.all(scores >= model.reject[None], dim=1)
    return torch.where(alive, scores[:, -1], -torch.inf)


def detect(img, model: WaldBoostModel, stride: int = 4, score_thresh: float = 0.0):
    """Sliding-window detection at the model's native scale. Returns
    (centers (N, 2), scores (N,)) above threshold, tensors on the image's
    device (the count is read once, at the end)."""
    img = as_float(img)
    H, W = img.shape
    win = model.win
    ys = torch.arange(win // 2, H - win // 2, stride, device=img.device)
    xs = torch.arange(win // 2, W - win // 2, stride, device=img.device)
    centers = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).reshape(-1, 2)
    feats = window_features(img, centers, model.pool, win=win)
    scores = _score_windows(feats, model)
    keep = torch.nonzero(scores > score_thresh).squeeze(1)  # the one read of the result's size
    return centers.index_select(0, keep), scores.index_select(0, keep)
