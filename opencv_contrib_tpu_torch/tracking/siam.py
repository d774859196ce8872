"""Siamese deep tracker (GOTURN / DaSiamRPN class), the port of
opencv_contrib_tpu/tracking/siam.py.

Reference anchors (tracking): src/gtrTracker.cpp + gtrUtils.cpp (GOTURN:
previous-frame target crop + current-frame search crop through a CNN -> new
box) and the DaSiamRPN sample (siamese template / search correlation with a
learned backbone).

No pretrained network is fetched: the backbone trains in the repo on
synthetic translated crops with SiamFC's objective (template features
cross-correlated over the search features, a Gaussian peak label at the
true offset). `SiamBackbone` is an `nn.Module` in NCHW; the public
functions keep the twin's layout, features (H, W, C). flax's "SAME" pads a
stride-2 3x3 convolution of an even side by (0, 1), not by (1, 1), so each
convolution pads explicitly (`models.layers.same_pad`); the kernels start
as flax's do (truncated lecun-normal, zero biases). The cross-correlation is
`F.conv2d` with the template as the kernel (the twin's `lax.conv`); every
product and convolution runs in full float32 (cuDNN's TF32 is off).
`interop.siam_params` carries the twin's flax parameters over.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from opencv_contrib_tpu_torch.models.layers import LECUN_TRUNC, lecun_normal_  # noqa: F401 (the tests read LECUN_TRUNC)
from opencv_contrib_tpu_torch.models.layers import same_pad as _same_pad
from opencv_contrib_tpu_torch.ops.image import sample_bilinear
from opencv_contrib_tpu_torch.tracking.correlation import _linspace
from opencv_contrib_tpu_torch.utils.device import constant
from opencv_contrib_tpu_torch.utils.optim import Adam, deterministic
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

TEMPLATE = 32  # template crop side
SEARCH = 64    # search crop side


class SiamBackbone(nn.Module):
    """Small fully-convolutional embedding (stride 4 total): (B, 1, H, W)
    -> (B, features, H / 4, W / 4)."""

    def __init__(self, features: int = 32):
        super().__init__()
        self.features = features
        self.conv1 = nn.Conv2d(1, 16, 3, stride=2)
        self.conv2 = nn.Conv2d(16, 32, 3, stride=2)
        self.conv3 = nn.Conv2d(32, features, 3)

    def reset_parameters(self, gen: torch.Generator) -> "SiamBackbone":
        """flax's Conv initialisation: kernels truncated normal of variance
        1 / fan_in (lecun_normal), biases zero; drawn from `gen`."""
        with torch.no_grad():
            for conv in (self.conv1, self.conv2, self.conv3):
                lecun_normal_(conv.weight, gen)
                conv.bias.zero_()
        return self

    def forward(self, x):
        x = torch.relu(self.conv1(_same_pad(x, 3, 2)))
        x = torch.relu(self.conv2(_same_pad(x, 3, 2)))
        return self.conv3(_same_pad(x, 3, 1))


def xcorr(search_feat: torch.Tensor, templ_feat: torch.Tensor) -> torch.Tensor:
    """Cross-correlate template features over search features.
    search (Hs, Ws, C), template (Ht, Wt, C) -> (Hs-Ht+1, Ws-Wt+1)."""
    with f32_matmul_precision():
        return F.conv2d(search_feat.permute(2, 0, 1)[None], templ_feat.permute(2, 0, 1)[None])[0, 0]


def _xcorr_batch(sf: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """xcorr of B pairs at once, NCHW: sf (B, C, Hs, Ws), tf (B, C, Ht, Wt)
    -> (B, Hr, Wr), one grouped convolution."""
    B, C = sf.shape[:2]
    return F.conv2d(sf.reshape(1, B * C, *sf.shape[2:]), tf, groups=B)[0]


def _crop_resize(img, center_yx, side, out_side):
    ys = _linspace(-side / 2, side / 2, out_side, img.device) + center_yx[0]
    xs = _linspace(-side / 2, side / 2, out_side, img.device) + center_yx[1]
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return sample_bilinear(img, yy, xx)


class SiamState(NamedTuple):
    templ_feat: torch.Tensor
    center: torch.Tensor  # (2,) y, x
    size: torch.Tensor    # (2,) h, w


def _embed_nchw(model: SiamBackbone, patches):
    """(B, H, W) -> mean-centred features (B, C, h, w)."""
    f = model(patches[:, None])
    return f - f.mean(dim=(2, 3), keepdim=True)


def _embed(model: SiamBackbone, patch):
    """(H, W) -> mean-centred features (h, w, C), the twin's layout."""
    with f32_matmul_precision():
        return _embed_nchw(model, patch[None])[0].permute(1, 2, 0)


def siam_init(model: SiamBackbone, img, bbox) -> SiamState:
    """bbox = (y, x, h, w). Extracts and embeds the template."""
    y, x, h, w = [float(v) for v in bbox]
    dev = img.device
    center = constant([y + h / 2.0, x + w / 2.0], dev)
    side = float(np.sqrt(h * w) * 1.5)
    with torch.no_grad():
        feat = _embed(model, _crop_resize(img.to(torch.float32), center, side, TEMPLATE))
    return SiamState(templ_feat=feat, center=center, size=constant([h, w], dev))


def _track_step(model: SiamBackbone, templ_feat, center, size, img):
    side = torch.sqrt(size[0] * size[1]) * 1.5 * (SEARCH / TEMPLATE)
    with torch.no_grad():
        sf = _embed(model, _crop_resize(img, center, side, SEARCH))
        resp = xcorr(sf, templ_feat)
    Hr, Wr = resp.shape
    dev = resp.device
    # cosine window against drift
    wy = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(Hr, device=dev) / (Hr - 1))
    wx = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(Wr, device=dev) / (Wr - 1))
    resp = resp * (0.7 + 0.3 * wy[:, None] * wx[None, :])
    idx = torch.argmax(resp)
    py, px = idx // Wr, idx % Wr
    # feature-grid displacement -> image pixels (backbone stride 4)
    stride = side / SEARCH * 4.0
    dy = (py - (Hr - 1) / 2.0) * stride
    dx = (px - (Wr - 1) / 2.0) * stride
    return center + torch.stack([dy, dx]), torch.take(resp, idx)


def siam_update(model: SiamBackbone, state: SiamState, img):
    """Track into the next frame; returns (new_state, bbox, score), bbox and
    score host floats as the twin's (three reads of the device)."""
    center, score = _track_step(model, state.templ_feat, state.center, state.size, img.to(torch.float32))
    new = SiamState(templ_feat=state.templ_feat, center=center, size=state.size)
    h, w = float(state.size[0]), float(state.size[1])
    bbox = (float(center[0]) - h / 2, float(center[1]) - w / 2, h, w)
    return new, bbox, float(score)


# ---------------------------------------------------------------------------
# In-repo training (SiamFC-style offline correlation objective)
# ---------------------------------------------------------------------------


def _synth_pair(rng, texture_side=16):
    """One (template_patch, search_patch, label_yx) training triple: a random
    textured object pasted on random clutter; the search crop shows it at a
    random offset (the twin's numpy draws, in its order)."""
    obj = rng.uniform(0, 1, (texture_side, texture_side)).astype(np.float32)
    t = np.zeros((TEMPLATE, TEMPLATE), np.float32)
    t += rng.uniform(0, 0.3, t.shape).astype(np.float32)
    o = (TEMPLATE - texture_side) // 2
    t[o:o + texture_side, o:o + texture_side] = obj

    s = rng.uniform(0, 0.3, (SEARCH, SEARCH)).astype(np.float32)
    # clutter: smooth distractor blobs (bright but texture-free)
    for _ in range(3):
        dy, dx = rng.integers(0, SEARCH - texture_side, 2)
        s[dy:dy + texture_side, dx:dx + texture_side] = rng.uniform(0.3, 0.8)
    max_off = (SEARCH - TEMPLATE) // 2 - 2
    off = rng.integers(-max_off, max_off + 1, 2)
    cy, cx = SEARCH // 2 + off[0], SEARCH // 2 + off[1]
    y0, x0 = cy - texture_side // 2, cx - texture_side // 2
    s[y0:y0 + texture_side, x0:x0 + texture_side] = obj
    return t, s, np.array(off, np.float32)


def _loss(model: SiamBackbone, templs, searches, offs):
    tf = _embed_nchw(model, templs)
    sf = _embed_nchw(model, searches)
    resps = _xcorr_batch(sf, tf)  # (B, Hr, Wr)
    B, Hr, Wr = resps.shape
    dev = resps.device
    # Gaussian label centred at the true offset (backbone stride 4)
    yy = torch.arange(Hr, device=dev)[None, :, None] - ((Hr - 1) / 2.0 + offs[:, 0:1, None] / 4.0)
    xx = torch.arange(Wr, device=dev)[None, None, :] - ((Wr - 1) / 2.0 + offs[:, 1:2, None] / 4.0)
    label = torch.exp(-(yy ** 2 + xx ** 2) / 2.0).reshape(B, -1)
    logp = torch.log_softmax(resps.reshape(B, -1), -1)
    label = label / label.sum(-1, keepdim=True)
    return -(label * logp).sum(-1).mean()


def train_siam(n_steps: int = 200, batch: int = 16, lr: float = 3e-3, seed: int = 0, features: int = 32,
               params=None, device="cpu") -> SiamBackbone:
    """Train the backbone on synthetic pairs (the twin's numpy draws of
    `seed`) with `utils.optim.Adam` (optax's update order); returns the
    trained SiamBackbone on `device`. `params` (a state dict, e.g.
    `interop.siam_params` of the twin's init) sets the start, else the
    kernels are drawn from a generator of `seed`."""
    dev = torch.device(device)
    model = SiamBackbone(features)
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    model = model.to(dev)
    rng = np.random.default_rng(seed)
    opt = Adam(model.parameters(), lr)
    with f32_matmul_precision(), deterministic():
        for _ in range(n_steps):
            trip = [_synth_pair(rng) for _ in range(batch)]
            templs = constant(np.stack([t for t, _, _ in trip]), dev)
            searches = constant(np.stack([s for _, s, _ in trip]), dev)
            offs = constant(np.stack([o for _, _, o in trip]), dev)
            opt.zero_grad()
            _loss(model, templs, searches, offs).backward()
            opt.step()
    return model
