"""Anchor-grid convolutional object detection (SqueezeDet-class), the port
of opencv_contrib_tpu/models/dnn_objdetect.py.

Parity target: dnn_objdetect/src/core_detect.cpp (InferBbox: ConvDet output
tensor -> anchor deltas -> sigmoid confidence x softmax class ->
threshold + NMS) and the SqueezeDet head the module ships configs for.

A small all-conv backbone (fire-module-lite, flax's names, `models.layers`)
with a ConvDet head predicting (conf, class logits, box deltas) per anchor
per cell. The functions keep the twin's layouts: images (N, H, W, C), the
head (N, Hc, Wc, A, 5 + C) with the channels split anchor-major as flax's
reshape splits them. NMS is the twin's top_k-step greedy scan over the IoU
matrix, on the device without a host read a step (a first-index argmax
and `torch.where`). `params` / `opt_state` of the twin's functional API are
the module itself and its `utils.optim.Adam` here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from opencv_contrib_tpu_torch.models.layers import Conv, reset_flax
from opencv_contrib_tpu_torch.utils.device import as_float, constant, resolve
from opencv_contrib_tpu_torch.utils.optim import Adam, deterministic
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

LR = 1e-3  # the twin's optax.adam(1e-3)


class FireLite(nn.Module):
    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.Conv_0 = Conv(cin, squeeze, 1)
        self.Conv_1 = Conv(squeeze, expand, 1)
        self.Conv_2 = Conv(squeeze, expand, 3)

    def forward(self, x):
        s = torch.relu(self.Conv_0(x))
        return torch.relu(torch.cat([self.Conv_1(s), self.Conv_2(s)], dim=1))


class SqueezeDetLite(nn.Module):
    """Backbone stride 8; ConvDet head outputs (A * (5 + n_classes)) maps:
    per anchor [conf, dy, dx, dh, dw, class logits...]. (N, H, W, C) ->
    (N, Hc, Wc, A, 5 + n_classes)."""

    def __init__(self, n_classes: int = 3, n_anchors: int = 3, channels: int = 1):
        super().__init__()
        self.n_classes, self.n_anchors = n_classes, n_anchors
        self.Conv_0 = Conv(channels, 16, 3, stride=2)
        self.FireLite_0 = FireLite(16, 8, 16)
        self.FireLite_1 = FireLite(32, 16, 32)
        self.FireLite_2 = FireLite(64, 16, 32)
        self.Conv_1 = Conv(64, n_anchors * (5 + n_classes), 3)

    def forward(self, x):
        h = torch.relu(self.Conv_0(x.permute(0, 3, 1, 2)))
        h = F.max_pool2d(self.FireLite_0(h), 2, 2)  # "VALID"
        h = F.max_pool2d(self.FireLite_1(h), 2, 2)
        out = self.Conv_1(self.FireLite_2(h)).permute(0, 2, 3, 1)
        N, Hc, Wc, _ = out.shape
        return out.reshape(N, Hc, Wc, self.n_anchors, 5 + self.n_classes)


def make_anchors(scales=(12.0, 24.0, 48.0), device="cpu"):
    """Square anchors (h, w) per cell (the reference reads anchor shapes
    from the model config)."""
    return constant([[s, s] for s in scales], device)


def decode(head, anchors, stride: int = 8):
    """ConvDet tensor -> (boxes [y0,x0,y1,x1], conf, class probs) for every
    anchor position (InferBbox::filter semantics, batched). head (Hc, Wc,
    A, 5+C) for ONE image."""
    head = as_float(head)
    Hc, Wc, A, _ = head.shape
    dev = head.device
    conf = torch.sigmoid(head[..., 0])
    deltas = head[..., 1:5]
    cls = torch.softmax(head[..., 5:], dim=-1)
    cy = (torch.arange(Hc, dtype=torch.float32, device=dev)[:, None, None] + 0.5) * stride
    cx = (torch.arange(Wc, dtype=torch.float32, device=dev)[None, :, None] + 0.5) * stride
    ah = anchors[None, None, :, 0]
    aw = anchors[None, None, :, 1]
    by = cy + deltas[..., 0] * ah
    bx = cx + deltas[..., 1] * aw
    bh = ah * torch.exp(torch.clamp(deltas[..., 2], -4, 4))
    bw = aw * torch.exp(torch.clamp(deltas[..., 3], -4, 4))
    boxes = torch.stack([by - bh / 2, bx - bw / 2, by + bh / 2, bx + bw / 2], dim=-1)
    return boxes.reshape(-1, 4), conf.reshape(-1), cls.reshape(-1, cls.shape[-1])


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(N, N) IoU of [y0, x0, y1, x1] boxes, the twin's arithmetic."""
    y0, x0, y1, x1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = torch.clamp(y1 - y0, min=0) * torch.clamp(x1 - x0, min=0)
    iy0 = torch.maximum(y0[:, None], y0[None])
    ix0 = torch.maximum(x0[:, None], x0[None])
    iy1 = torch.minimum(y1[:, None], y1[None])
    ix1 = torch.minimum(x1[:, None], x1[None])
    inter = torch.clamp(iy1 - iy0, min=0) * torch.clamp(ix1 - ix0, min=0)
    return inter / torch.clamp(area[:, None] + area[None] - inter, min=1e-9)


def nms(boxes, scores, iou_thresh: float = 0.4, top_k: int = 32):
    """Greedy NMS via the IoU suppression matrix: top_k steps, each taking
    the best remaining box (the first of equal scores) and masking its
    overlaps. Static shapes; returns (indices (top_k,) int64, valid
    (top_k,) bool) on the boxes' device."""
    boxes, scores = as_float(boxes), as_float(scores)
    iou = iou_matrix(boxes)
    n = scores.shape[0]
    ar = torch.arange(n, device=scores.device)
    alive = torch.ones(n, dtype=torch.bool, device=scores.device)
    neg_inf = torch.full_like(scores, -float("inf"))
    idx, valid = [], []
    for _ in range(top_k):
        s = torch.where(alive, scores, neg_inf)
        best, i = s.max(0)
        suppress = iou.index_select(0, i.reshape(1))[0] > iou_thresh
        alive = alive & ~suppress & (ar != i)
        idx.append(i)
        valid.append(best > -float("inf"))
    return torch.stack(idx), torch.stack(valid)


def detect(params: SqueezeDetLite, model: SqueezeDetLite, img, anchors, conf_thresh: float = 0.5,
           iou_thresh: float = 0.4, stride: int = 8):
    """Full detection for one grayscale/RGB image (H, W[, C]) on the
    model's device. Returns (boxes, scores, class_ids) numpy arrays (one
    read of the device)."""
    dev = next(params.parameters()).device
    x = img.to(dev, torch.float32) if isinstance(img, torch.Tensor) else constant(np.asarray(img, np.float32), dev)
    if x.ndim == 2:
        x = x[..., None]
    with torch.no_grad(), f32_matmul_precision():
        head = params(x[None])[0]
        boxes, conf, cls = decode(head, anchors.to(dev), stride=stride)
        score = conf * cls.max(-1).values
        cid = cls.argmax(-1)
        idx, valid = nms(boxes, torch.where(score >= conf_thresh, score, torch.full_like(score, -float("inf"))),
                         iou_thresh)
    sel_boxes, sel_scores, sel_cid = boxes[idx], score[idx], cid[idx]
    idxn, validn = idx.cpu().numpy(), valid.cpu().numpy()
    b, sn, c = sel_boxes.cpu().numpy()[validn], sel_scores.cpu().numpy()[validn], sel_cid.cpu().numpy()[validn]
    keep = sn >= conf_thresh
    return b[keep], sn[keep], c[keep]


def _sigmoid_bce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _softmax_ce_int(logits, labels):
    """optax.softmax_cross_entropy_with_integer_labels (the max taken out
    without a gradient)."""
    logits = logits - logits.max(-1, keepdim=True).values.detach()
    label_logits = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.log(torch.exp(logits).sum(-1)) - label_logits


def detection_loss(params: SqueezeDetLite, model: SqueezeDetLite, imgs, tgt_conf, tgt_boxes, tgt_cls, anchors,
                   stride: int = 8):
    """SqueezeDet training loss: conf BCE + masked box L2 + masked class CE.
    tgt_conf (N, Hc, Wc, A) in {0,1}; tgt_boxes (N, Hc, Wc, A, 4) deltas;
    tgt_cls (N, Hc, Wc, A) int."""
    head = params(imgs)
    conf = head[..., 0]
    bce = _sigmoid_bce(conf, tgt_conf).mean()
    m = tgt_conf[..., None]
    box_l2 = ((head[..., 1:5] - tgt_boxes) ** 2 * m).sum() / torch.clamp(m.sum(), min=1)
    ce = _softmax_ce_int(head[..., 5:], tgt_cls)
    ce = (ce * tgt_conf).sum() / torch.clamp(tgt_conf.sum(), min=1)
    return bce + 5.0 * box_l2 + ce


def train_step(params: SqueezeDetLite, opt_state: Adam, model: SqueezeDetLite, imgs, tgt_conf, tgt_boxes, tgt_cls,
               anchors, tx_hash=None):
    """One Adam step (lr 1e-3) on `detection_loss`; returns (params,
    opt_state, loss), the loss a device scalar. The inputs are tensors on
    the model's device."""
    with f32_matmul_precision(), deterministic():
        opt_state.zero_grad()
        loss = detection_loss(params, model, imgs, tgt_conf, tgt_boxes, tgt_cls, anchors)
        loss.backward()
        opt_state.step()
    return params, opt_state, loss.detach()


def init(key, model: SqueezeDetLite, img_hw=(96, 96), channels: int = 1, device="cuda", params=None):
    """flax's initialisers drawn from a generator of `key` (an int seed or a
    torch.Generator), or `params` (a state dict, e.g.
    `interop.squeezedet_params` of the twin's init), the model moved to
    `device`; returns (model, its Adam). img_hw and channels are the twin's
    shape arguments (the module fixes its input channels)."""
    if channels != model.Conv_0.in_channels:
        raise ValueError(f"the model takes {model.Conv_0.in_channels} channels, not {channels}")
    if params is None:
        gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
        reset_flax(model, gen)
    else:
        model.load_state_dict(params)
    model.to(resolve(device))
    return model, Adam(model.parameters(), LR)
