"""Learned QR detection + super-resolution stages, trained in-repo (the port
of opencv_contrib_tpu/wechat_qrcode/learned.py).

The reference wechat_qrcode pipeline is SSD CNN detect -> SR CNN ->
decode (wechat_qrcode/src/detector/ssd_detector.cpp, super_scale.cpp),
shipping both CNNs as binary caffemodels. Here both stages are TRAINED
IN-REPO on rendered QR codes:

- QrDetectorNet: a tiny fully-convolutional CenterNet-lite (stride-8
  objectness heatmap + center offset + log-size) trained on codes
  composited onto procedural backgrounds under blur/noise/downscaling.
- SR stage: the dnn_superres ESPCN x2 trained on degraded QR crops.

The training scenes, their blur and noise and the targets come from the
twin's numpy draws in its order; the resizes are `ops.image.image_resize`
(the twin of `jax.image.resize`). detect_and_decode_learned composes
detect -> crop -> (SR if small) -> classical decode (the port's
`qr.detect_and_decode`), with the twin's full-frame classical decode as
the last resort. The box's corners truncate toward zero as the twin's
Python `int` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from opencv_contrib_tpu_torch.models.layers import Conv, check_state, reset_flax
from opencv_contrib_tpu_torch.ops.image import image_resize
from opencv_contrib_tpu_torch.utils.device import constant, resolve, to_device
from opencv_contrib_tpu_torch.utils.optim import Adam, deterministic
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision
from opencv_contrib_tpu_torch.wechat_qrcode import qr as qrmod

DET_SIZE = 128  # detector input resolution
STRIDE = 8


class QrDetectorNet(nn.Module):
    """(N, 128, 128, 1) -> heat (N, 16, 16, 1) logits, offset (N, 16, 16, 2)
    in cells, log size (N, 16, 16, 1), the twin's layouts."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(1, 8, 3, stride=2)
        self.Conv_1 = Conv(8, 16, 3, stride=2)
        self.Conv_2 = Conv(16, 32, 3, stride=2)
        self.Conv_3 = Conv(32, 32, 3)
        self.Conv_4 = Conv(32, 1, 1)
        self.Conv_5 = Conv(32, 2, 1)
        self.Conv_6 = Conv(32, 1, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2, self.Conv_3):
            x = torch.relu(conv(x))
        return tuple(c(x).permute(0, 2, 3, 1) for c in (self.Conv_4, self.Conv_5, self.Conv_6))


class QrDetector(NamedTuple):
    params: QrDetectorNet  # the trained network (the twin keeps its flax parameters)

    def detect(self, img):
        """Best QR box on a gray [0,1] image -> (y0, x0, y1, x1) in source
        pixels + score (sigmoid objectness), on the network's device with
        one read of the device."""
        dev = next(self.params.parameters()).device
        x = to_device(img, dev)
        H, W = x.shape
        with torch.no_grad(), f32_matmul_precision():
            heat, off, size = self.params(image_resize(x, (DET_SIZE, DET_SIZE), "bilinear")[None, ..., None])
        h = heat[0, ..., 0].reshape(-1)
        i = torch.argmax(h).reshape(1)  # the first of equal logits, as np.argmax
        picked = torch.cat([h.index_select(0, i), off[0].reshape(-1, 2).index_select(0, i)[0],
                            size[0].reshape(-1).index_select(0, i), i.to(torch.float32)])
        hv, oy, ox, sv, flat = picked.cpu().numpy()
        cy, cx = np.unravel_index(int(flat), heat.shape[1:3])
        score = 1.0 / (1.0 + np.exp(-hv))
        s = float(np.exp(sv)) * 32.0
        ctr_y = (cy + 0.5 + oy) * STRIDE
        ctr_x = (cx + 0.5 + ox) * STRIDE
        sy, sx = H / DET_SIZE, W / DET_SIZE
        half = s / 2.0
        return (int((ctr_y - half) * sy), int((ctr_x - half) * sx),
                int((ctr_y + half) * sy), int((ctr_x + half) * sx)), score


# ---------------------------------------------------------------------------
# training-scene synthesis (host numpy, the twin's draws)

def _host_resize(a: np.ndarray, shape, method: str) -> np.ndarray:
    return image_resize(torch.from_numpy(np.ascontiguousarray(a, np.float32)), shape, method).numpy()


def _background(rng, size=DET_SIZE):
    g = rng.standard_normal((size // 8, size // 8)).astype(np.float32)
    bg = _host_resize(g, (size, size), "bilinear")
    bg = 0.5 + 0.25 * bg / max(np.abs(bg).max(), 1e-6)
    return np.clip(bg, 0, 1)


def _blur(img, sigma):
    if sigma <= 0:
        return img
    r = max(1, int(2 * sigma))
    t = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    out = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), 0, img)
    return np.apply_along_axis(
        lambda m: np.convolve(m, k, "same"), 1, out).astype(np.float32)


def make_training_scene(rng, degrade=True):
    """One composited detector training image + (ctr_y, ctr_x, side)."""
    text = "".join(chr(rng.integers(65, 91)) for _ in range(rng.integers(4, 12)))
    mod = qrmod.encode(text, mask_id=int(rng.integers(0, 8)))
    n = mod.shape[0]
    side = int(rng.integers(40, 100))
    scale = max(1, side // (n + 8))
    patch = qrmod.render(mod, scale=scale, border=2).astype(np.float32)
    ph = patch.shape[0]
    img = _background(rng)
    y0 = int(rng.integers(0, DET_SIZE - ph))
    x0 = int(rng.integers(0, DET_SIZE - ph))
    img[y0:y0 + ph, x0:x0 + ph] = patch
    if degrade:
        if rng.random() < 0.6:
            img = _blur(img, rng.uniform(0.5, 1.5))
        img = np.clip(img + rng.standard_normal(img.shape) * rng.uniform(0, 0.06),
                      0, 1).astype(np.float32)
    return img, (y0 + ph / 2.0, x0 + ph / 2.0, float(ph))


def detector_batch(rng, batch: int):
    """`batch` training scenes (batch, 128, 128) and their targets (batch,
    3) float32, drawn as the twin's `train_detector` draws a step's."""
    imgs, tgts = [], []
    for _ in range(batch):
        im, t = make_training_scene(rng)
        imgs.append(im)
        tgts.append(t)
    return np.stack(imgs), np.asarray(tgts, np.float32)


def detector_loss(net: QrDetectorNet, imgs, targets):
    """The twin's heatmap BCE (the one positive cell up-weighted to the
    rest's count) + 0.5 |offset| + 0.5 |log size| at the target's cell."""
    G = DET_SIZE // STRIDE
    heat, off, size = net(imgs)
    N = imgs.shape[0]
    cy, cx, side = targets[:, 0], targets[:, 1], targets[:, 2]
    gy = torch.clamp((cy / STRIDE).to(torch.int32), 0, G - 1).long()
    gx = torch.clamp((cx / STRIDE).to(torch.int32), 0, G - 1).long()
    b = torch.arange(N, device=imgs.device)
    tgt = F.one_hot(gy * G + gx, G * G).reshape(N, G, G).to(torch.float32)  # no host value written
    logits = heat[..., 0]
    bce = -tgt * F.logsigmoid(logits) - (1.0 - tgt) * F.logsigmoid(-logits)
    w = 1.0 + tgt * (G * G - 1.0)
    l_heat = torch.mean(bce * w)
    oy = cy / STRIDE - (gy + 0.5)
    ox = cx / STRIDE - (gx + 0.5)
    l_off = torch.mean(torch.abs(off[b, gy, gx, 0] - oy) + torch.abs(off[b, gy, gx, 1] - ox))
    l_size = torch.mean(torch.abs(size[b, gy, gx, 0] - torch.log(side / 32.0)))
    return l_heat + 0.5 * l_off + 0.5 * l_size


def detector_batches(n_steps: int = 300, batch: int = 16, seed: int = 0) -> list:
    """The (images, targets) of every step of `train_detector(n_steps,
    batch, seed)`, drawn as it draws them: host numpy, to be made in
    another process ahead of the training."""
    rng = np.random.default_rng(seed)
    return [detector_batch(rng, batch) for _ in range(n_steps)]


def train_detector(n_steps: int = 300, batch: int = 16, seed: int = 0, lr: float = 2e-3, params=None,
                   device="cuda", batches=None) -> QrDetector:
    """Train the detector head (ssd_detector.cpp role) on `device` from the
    twin's draws of `seed` (or from `batches`, `detector_batches(n_steps,
    batch, seed)` made ahead). `params` (a state dict, e.g.
    `interop.qr_detector_params` of the twin's init) sets the start, else
    flax's initialisers draw it from a generator of `seed`."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    if batches is None:
        batches = (detector_batch(rng, batch) for _ in range(n_steps))
    net = QrDetectorNet()
    if params is None:
        reset_flax(net, torch.Generator().manual_seed(seed))
    else:
        net.load_state_dict(check_state(net, params, "QrDetectorNet"))
    net.to(dev)
    opt = Adam(net.parameters(), lr)
    with f32_matmul_precision(), deterministic():
        for imgs, tgts in batches:
            opt.zero_grad()
            detector_loss(net, constant(imgs[..., None], dev), constant(tgts, dev)).backward()
            opt.step()
    return QrDetector(net)


def sr_batch(rng, batch: int):
    """`batch` (LR 48 x 48, HR 96 x 96) QR crops, drawn as the twin's
    `train_qr_sr` draws a step's."""
    lrs, hrs = [], []
    for _ in range(batch):
        text = "".join(chr(rng.integers(65, 91)) for _ in range(6))
        mod = qrmod.encode(text, mask_id=int(rng.integers(0, 8)))
        hr = qrmod.render(mod, scale=4, border=2).astype(np.float32)
        hr = hr[:96, :96] if hr.shape[0] >= 96 else np.pad(
            hr, ((0, 96 - hr.shape[0]), (0, 96 - hr.shape[1])),
            constant_values=1.0)
        lr_img = _host_resize(hr, (48, 48), "bilinear")
        lr_img = _blur(lr_img, float(rng.uniform(0.0, 0.8)))
        lrs.append(lr_img)
        hrs.append(hr)
    return np.stack(lrs)[..., None], np.stack(hrs)[..., None]


def sr_batches(n_steps: int = 200, batch: int = 8, seed: int = 0) -> list:
    """The (LR, HR) batches of every step of `train_qr_sr(n_steps, batch,
    seed)`, drawn as it draws them (host numpy)."""
    rng = np.random.default_rng(seed)
    return [sr_batch(rng, batch) for _ in range(n_steps)]


def train_qr_sr(n_steps: int = 200, batch: int = 8, seed: int = 0, params=None, device="cuda", batches=None):
    """ESPCN x2 trained on degraded QR crops (super_scale.cpp role) on
    `device`, from the twin's draws of `seed` (or from `batches`,
    `sr_batches(n_steps, batch, seed)` made ahead); `params` as
    `DnnSuperRes`'s."""
    from opencv_contrib_tpu_torch.models.dnn_superres import DnnSuperRes

    sr = DnnSuperRes("espcn", scale=2, seed=seed, device=device, params=params)
    sr.init_training(lr=2e-3)
    rng = np.random.default_rng(seed)
    for lr_b, hr_b in (batches if batches is not None else (sr_batch(rng, batch) for _ in range(n_steps))):
        sr.train_step(lr_b, hr_b)
    return sr


# ---------------------------------------------------------------------------
# composed pipeline

def detect_and_decode_learned(img, detector: QrDetector, sr=None, min_crop_px: int = 120):
    """CNN detect -> crop -> (SR x2 when the crop is small) -> classical
    decode, with a full-frame classical fallback
    (WeChatQRCode::detectAndDecode contract, wechat_qrcode.hpp:24). The
    frame and the crops stay on the detector's device."""
    dev = next(detector.params.parameters()).device
    img = to_device(img, dev)
    box, score = detector.detect(img)
    H, W = img.shape
    y0, x0, y1, x1 = box
    m = int(0.15 * max(y1 - y0, x1 - x0))
    y0, x0 = max(0, y0 - m), max(0, x0 - m)
    y1, x1 = min(H, y1 + m), min(W, x1 + m)
    if score > 0.3 and y1 - y0 > 10 and x1 - x0 > 10:
        crop = img[y0:y1, x0:x1]
        if sr is not None and max(crop.shape) < min_crop_px:
            crop = sr.upsample(crop)
        text, _ = qrmod.detect_and_decode(crop)
        if text is not None:
            return text
        if sr is not None and max(crop.shape) < 2 * min_crop_px:
            crop2 = sr.upsample(crop)
            text, _ = qrmod.detect_and_decode(crop2)
            if text is not None:
                return text
    return qrmod.detect_and_decode(img)[0]
