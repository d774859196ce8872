"""TLD (Tracking-Learning-Detection): median-flow tracking, a scanning
detection cascade and P/N learning (the port of
opencv_contrib_tpu/tracking/tld.py).

Reference anchors: tracking/src/tld*.cpp: tldDetector.cpp (variance filter
-> fern ensemble -> NN/NCC stages over a scanning-window grid),
tldEnsembleClassifier (pixel-comparison ferns), tldModel.cpp (positive /
negative example stores, P/N updates), tldTracker.cpp (median-flow +
detector fusion, relocalization after loss).

All three cascade stages evaluate every window of the static scanning grid
as batched tensor ops, with the stage gates as masks. The twin's
`lax.cond`s are `torch.where`s over both branches: a step reads nothing
back to the host. The fern counts are integer-valued adds, exact in any
order (`ops.segment.segment_count`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.ops.segment import segment_count
from opencv_contrib_tpu_torch.tracking.correlation import _linspace, _vec
from opencv_contrib_tpu_torch.tracking.medianflow import Box, medianflow_update
from opencv_contrib_tpu_torch.utils.device import constant

PATCH = 15  # normalized patch side (the reference's 15x15 NN stage)
N_FERNS = 10
N_PAIRS = 8  # comparisons per fern -> 256-entry posterior tables
N_EXAMPLES = 64  # capacity of the positive/negative example stores


def fern_bank(gen: torch.Generator):
    """Random comparison-pair coordinates in [0,1)^2 per fern, drawn from
    `gen` on its device."""
    return torch.rand((N_FERNS, N_PAIRS, 2, 2), generator=gen, device=gen.device)


class TldState(NamedTuple):
    box: Box
    posteriors: torch.Tensor  # (N_FERNS, 2**N_PAIRS) fern P(pos|code)
    counts: torch.Tensor  # (N_FERNS, 2**N_PAIRS, 2) pos/neg counts
    pos_ex: torch.Tensor  # (N_EXAMPLES, PATCH*PATCH) normalized patches
    neg_ex: torch.Tensor
    n_pos: torch.Tensor  # () int
    n_neg: torch.Tensor
    tracking: torch.Tensor  # () bool: the tracker's confidence state


def _extract_norm(img, boxes_c, boxes_hw):
    """Each box sampled to PATCH x PATCH and zero-mean normalized:
    boxes_c (N, 2), boxes_hw (N, 2) -> (N, PATCH*PATCH)."""
    dev = img.device
    t = (torch.arange(PATCH, device=dev) + 0.5) / PATCH - 0.5
    y = boxes_c[:, 0, None, None] + t[None, :, None] * boxes_hw[:, 0, None, None]
    x = boxes_c[:, 1, None, None] + t[None, None, :] * boxes_hw[:, 1, None, None]
    p = sample_bilinear(img, y * torch.ones((1, 1, PATCH), device=dev), x * torch.ones((1, PATCH, 1), device=dev))
    p = p.reshape(p.shape[0], -1)
    return p - p.mean(dim=1, keepdim=True)


def _fern_codes(img, boxes_c, boxes_hw, bank):
    """Binary codes per (window, fern): pixel pairs compared at
    box-normalized coordinates (tldEnsembleClassifier)."""
    rel = bank - 0.5  # (F, P, 2, 2) in [-0.5, 0.5)
    y = boxes_c[:, None, None, None, 0] + rel[None, ..., 0] * boxes_hw[:, None, None, None, 0]
    x = boxes_c[:, None, None, None, 1] + rel[None, ..., 1] * boxes_hw[:, None, None, None, 1]
    v = sample_bilinear(img, y, x)  # (N, F, P, 2)
    bits = (v[..., 0] > v[..., 1]).to(torch.int64)  # (N, F, P)
    weights = 2 ** torch.arange(N_PAIRS, device=img.device)
    return (bits * weights[None, None]).sum(-1)  # (N, F)


def _nn_conf(patches, pos_ex, neg_ex, n_pos, n_neg):
    """Relative similarity (tldModel Sr): NCC against the example stores."""

    def ncc(a, b):
        num = a @ b.T
        den = torch.linalg.norm(a, dim=1)[:, None] * torch.linalg.norm(b, dim=1)[None] + 1e-9
        return (num / den + 1.0) / 2.0

    idx = torch.arange(N_EXAMPLES, device=patches.device)
    zero = torch.zeros((), device=patches.device)
    sp = torch.amax(torch.where((idx < n_pos)[None], ncc(patches, pos_ex), zero), dim=1)
    sn = torch.amax(torch.where((idx < n_neg)[None], ncc(patches, neg_ex), zero), dim=1)
    return sp / (sp + sn + 1e-9)


def _scan_grid(box: Box, H, W, n_scales: int = 3, stride_frac: float = 0.25):
    """The static scanning-window grid over the whole frame at several
    scales of the current box (tldDetector's grid)."""
    dev = box.size.device
    centers, sizes = [], []
    for s in range(n_scales):
        scale = 1.2 ** (s - n_scales // 2)
        hw = box.size * scale
        ny, nx = 12, 12
        cy = _linspace(0.0, 1.0, ny, dev) * (H - 1)
        cx = _linspace(0.0, 1.0, nx, dev) * (W - 1)
        g = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), dim=-1).reshape(-1, 2)
        centers.append(g)
        sizes.append(hw[None].expand(g.shape[0], 2))
    return torch.cat(centers), torch.cat(sizes)


def _push(store, count, ex):
    """Ring-buffer insert of one example row (no host read of the count)."""
    i = (count % N_EXAMPLES).reshape(1).long()
    return store.index_copy(0, i, ex[None]), count + 1


def tld_init(img, center_yx, size_hw, gen: torch.Generator | None = None, bank=None) -> TldState:
    """The state after learning the first frame; the fern bank is `bank`,
    else `fern_bank(gen)`."""
    dev = img.device
    box = Box(_vec(center_yx, dev), _vec(size_hw, dev))
    n_codes = 2 ** N_PAIRS
    st = TldState(
        box,
        torch.full((N_FERNS, n_codes), 0.5, device=dev),
        torch.zeros((N_FERNS, n_codes, 2), device=dev),
        torch.zeros((N_EXAMPLES, PATCH * PATCH), device=dev),
        torch.zeros((N_EXAMPLES, PATCH * PATCH), device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.ones((), dtype=torch.bool, device=dev),
    )
    return _tld_learn_init(st, img, fern_bank(gen) if bank is None else bank.to(dev))


def _far_windows(H: int, W: int, device):
    """The four far-away negative windows' centres (the twin's host list)."""
    return constant([[H * 0.15, W * 0.15], [H * 0.15, W * 0.85], [H * 0.85, W * 0.15], [H * 0.85, W * 0.85]],
                    device)


def _tld_learn_init(st: TldState, img, bank):
    # positive: the init box; negatives: far-away windows
    pos = _extract_norm(img, st.box.center[None], st.box.size[None])
    pos_ex, n_pos = _push(st.pos_ex, st.n_pos, pos[0])
    H, W = img.shape
    far = _far_windows(H, W, img.device)
    sizes = st.box.size[None].expand(4, 2)
    negs = _extract_norm(img, far, sizes)
    neg_ex, n_neg = st.neg_ex, st.n_neg
    for i in range(4):
        neg_ex, n_neg = _push(neg_ex, n_neg, negs[i])
    counts = _fern_update(st.counts, img, st.box.center[None], st.box.size[None], bank, True)
    counts = _fern_update(counts, img, far, sizes, bank, False)
    post = (counts[..., 0] + 1.0) / (counts.sum(-1) + 2.0)
    return st._replace(posteriors=post, counts=counts, pos_ex=pos_ex, neg_ex=neg_ex, n_pos=n_pos, n_neg=n_neg)


def _fern_update(counts, img, boxes_c, boxes_hw, bank, positive):
    codes = _fern_codes(img, boxes_c, boxes_hw, bank)  # (N, F)
    cls = 0 if positive else 1
    f_idx = torch.arange(N_FERNS, device=img.device)[None].expand_as(codes)
    flat = (f_idx.reshape(-1) * 2 ** N_PAIRS + codes.reshape(-1)) * 2 + cls
    return counts + segment_count(flat, counts.numel()).reshape(counts.shape)


def tld_update(st: TldState, I0, I1, bank, conf_thresh: float = 0.6):
    """One TLD step on the frame pair (I0 -> I1): median-flow track,
    full-frame detect, fuse, P/N learn. Returns (new_state, confidence)."""
    H, W = I1.shape
    tracked_box, trk_ok = medianflow_update(st.box, I0, I1, grid=8, levels=2)
    trk_ok = trk_ok & st.tracking

    # --- detection cascade over the scanning grid
    centers, sizes = _scan_grid(st.box, H, W)
    patches = _extract_norm(I1, centers, sizes)
    # stage 1: variance filter (population variances, as the twin's)
    var = patches.var(dim=1, correction=0)
    pos_var = torch.where(st.n_pos > 0, st.pos_ex[0].var(correction=0), torch.ones((), device=I1.device))
    pass1 = var > 0.5 * pos_var
    # stage 2: fern ensemble average posterior
    codes = _fern_codes(I1, centers, sizes, bank)
    fern_p = torch.gather(st.posteriors, 1, codes.T).mean(0)
    pass2 = pass1 & (fern_p > 0.5)
    # stage 3: NN relative similarity
    nn = _nn_conf(patches, st.pos_ex, st.neg_ex, st.n_pos, st.n_neg)
    det_score = torch.where(pass2, nn, torch.zeros_like(nn))
    det_best = torch.argmax(det_score).reshape(1)
    det_conf = det_score.index_select(0, det_best)[0]

    # --- fusion: the tracker wins when alive; the detector relocalizes on loss
    trk_patch = _extract_norm(I1, tracked_box.center[None], tracked_box.size[None])
    trk_conf = _nn_conf(trk_patch, st.pos_ex, st.neg_ex, st.n_pos, st.n_neg)[0]
    use_det = (~trk_ok) & (det_conf > conf_thresh)
    center = torch.where(use_det, centers.index_select(0, det_best)[0], tracked_box.center)
    size = torch.where(use_det, sizes.index_select(0, det_best)[0], tracked_box.size)
    conf = torch.where(use_det, det_conf, torch.where(trk_ok, trk_conf, torch.zeros_like(trk_conf)))
    new_box = Box(center, size)

    # --- P/N learning (only when confident, tldModel.cpp's rule): both
    # branches computed, the learnt one selected
    learn = conf > conf_thresh
    cur = _extract_norm(I1, center[None], size[None])[0]
    pushed, n_pushed = _push(st.pos_ex, st.n_pos, cur)
    pos_ex, n_pos = torch.where(learn, pushed, st.pos_ex), torch.where(learn, n_pushed, st.n_pos)
    # N-expert: high-fern-score windows far from the target are negatives
    d = torch.linalg.norm(centers - center[None], dim=1)
    hard_neg = torch.argmax(torch.where((d > (size[0] + size[1])) & pass1, fern_p,
                                        torch.full_like(fern_p, -1.0))).reshape(1)
    neg_patch = patches.index_select(0, hard_neg)[0]
    pushed, n_pushed = _push(st.neg_ex, st.n_neg, neg_patch)
    neg_ex, n_neg = torch.where(learn, pushed, st.neg_ex), torch.where(learn, n_pushed, st.n_neg)
    learnt = _fern_update(_fern_update(st.counts, I1, center[None], size[None], bank, True),
                          I1, centers.index_select(0, hard_neg), sizes.index_select(0, hard_neg), bank, False)
    counts = torch.where(learn, learnt, st.counts)
    post = (counts[..., 0] + 1.0) / (counts.sum(-1) + 2.0)
    tracking = trk_ok | use_det
    return TldState(new_box, post, counts, pos_ex, neg_ex, n_pos, n_neg, tracking), conf
