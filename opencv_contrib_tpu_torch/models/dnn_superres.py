"""Single-image super-resolution models (ESPCN / FSRCNN / EDSR / LapSRN), the
port of opencv_contrib_tpu/models/dnn_superres.py.

API parity with DnnSuperResImpl: set model + scale, `upsample(img)`;
weights save/load via npz; `train_step` for fitting on (LR, HR) pairs. The
networks are `nn.Module`s on NCHW tensors whose submodules carry flax's
names (`models.layers`), so `save_model` writes the twin's npz keys and
arrays (kernels HWIO) and either package reads the other's file. The pixel
shuffles are the twin's (N, H, W, s, s) -> (N, H, s, W, s), which is
`F.pixel_shuffle`'s order. The bilinear base and the bicubic resizes are
`ops.image.image_resize`, the twin of `jax.image.resize`. PSNR and SSIM go
through the port's `quality.psnr` / `ssim` (the grid_transform and
grid_reduce kernels on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from opencv_contrib_tpu_torch.models.layers import (Conv, PReLU, check_state, flax_to_state_dict, leaky_relu,
                                                    reset_flax, state_dict_to_flax)
from opencv_contrib_tpu_torch.ops.image import image_resize
from opencv_contrib_tpu_torch.utils.device import resolve, to_device
from opencv_contrib_tpu_torch.utils.optim import Adam, deterministic
from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision


class ESPCN(nn.Module):
    """Shi et al. efficient sub-pixel CNN: (N, 1, H, W) -> (N, 1, sH, sW)."""

    def __init__(self, scale: int = 2, features: int = 32):
        super().__init__()
        self.scale = scale
        self.Conv_0 = Conv(1, features, 5)
        self.Conv_1 = Conv(features, features // 2, 3)
        self.Conv_2 = Conv(features // 2, scale * scale, 3)

    def forward(self, x):
        h = torch.tanh(self.Conv_0(x))
        h = torch.tanh(self.Conv_1(h))
        return F.pixel_shuffle(self.Conv_2(h), self.scale)


class FSRCNN(nn.Module):
    """Dong et al. fast SRCNN: feature extraction -> shrink -> map ->
    expand -> the 9 x 9 stride-s deconvolution as s^2 phase filters on the
    LR grid + depth-to-space (the twin's parameterisation)."""

    def __init__(self, scale: int = 2, d: int = 32, s: int = 8):
        super().__init__()
        self.scale = scale
        k = -(-9 // scale)  # per-phase kernel support of the 9x9 deconv
        for i, (cin, cout, kk) in enumerate(((1, d, 5), (d, s, 1), (s, s, 3), (s, s, 3), (s, d, 1),
                                              (d, scale * scale, k))):
            setattr(self, f"Conv_{i}", Conv(cin, cout, kk))
        for i in range(5):
            setattr(self, f"PReLU_{i}", PReLU())

    def forward(self, x):
        h = x
        for i in range(5):
            h = getattr(self, f"PReLU_{i}")(getattr(self, f"Conv_{i}")(h))
        return F.pixel_shuffle(self.Conv_5(h), self.scale)


class EDSR(nn.Module):
    """Lim et al. enhanced deep SR (lite): residual blocks without BN, 0.1
    residual scaling, a pixel-shuffle tail."""

    def __init__(self, scale: int = 2, features: int = 32, n_blocks: int = 4):
        super().__init__()
        self.scale, self.n_blocks = scale, n_blocks
        self.Conv_0 = Conv(1, features, 3)
        for i in range(1, 2 * n_blocks + 2):
            setattr(self, f"Conv_{i}", Conv(features, features, 3))
        setattr(self, f"Conv_{2 * n_blocks + 2}", Conv(features, scale * scale, 3))

    def forward(self, x):
        h0 = self.Conv_0(x)
        h = h0
        for b in range(self.n_blocks):
            r = torch.relu(getattr(self, f"Conv_{2 * b + 1}")(h))
            h = h + 0.1 * getattr(self, f"Conv_{2 * b + 2}")(r)
        h = getattr(self, f"Conv_{2 * self.n_blocks + 1}")(h) + h0
        return F.pixel_shuffle(getattr(self, f"Conv_{2 * self.n_blocks + 2}")(h), self.scale)


class LapSRN(nn.Module):
    """Lai et al. Laplacian-pyramid SR: log2(scale) x2 stages, each a
    residual (a 4 x 4 stride-2 deconvolution as 4 phase filters of a 2 x 2
    "SAME" convolution, padded (0, 1)) added to the bilinear x2 base."""

    def __init__(self, scale: int = 2, features: int = 16):
        super().__init__()
        self.scale = scale
        self.n_stages = int(np.log2(scale))
        for st in range(self.n_stages):
            setattr(self, f"Conv_{3 * st}", Conv(1, features, 3))
            setattr(self, f"Conv_{3 * st + 1}", Conv(features, features, 3))
            setattr(self, f"Conv_{3 * st + 2}", Conv(features, 4, 2))

    def forward(self, x):
        out = x
        for st in range(self.n_stages):
            feat = leaky_relu(getattr(self, f"Conv_{3 * st}")(out), 0.2)
            feat = leaky_relu(getattr(self, f"Conv_{3 * st + 1}")(feat), 0.2)
            res = F.pixel_shuffle(getattr(self, f"Conv_{3 * st + 2}")(feat), 2)
            N, _, H, W = out.shape
            out = image_resize(out, (N, 1, 2 * H, 2 * W), "bilinear") + res
        return out


NETS = {"espcn": ESPCN, "fsrcnn": FSRCNN, "edsr": EDSR, "lapsrn": LapSRN}


def _flax_key(path) -> str:
    """The twin's npz key of a parameter path ("params", "Conv_0", "bias"):
    the string of jax's key path, "['params']/['Conv_0']/['bias']"."""
    return "/".join(f"[{p!r}]" for p in path)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class DnnSuperRes:
    """DnnSuperResImpl-contract wrapper. The network lives on `device`
    ("cuda" unless the CPU is asked for); `params` (a state dict, e.g.
    `interop.superres_params` of the twin's) sets its weights, else flax's
    initialisers draw them from a generator of `seed`."""

    def __init__(self, algo: str = "espcn", scale: int = 2, seed: int = 0, device="cuda", params=None):
        if algo not in NETS:
            raise ValueError(f"unknown algo {algo} (espcn|fsrcnn|edsr|lapsrn)")
        self.algo, self.scale, self.dev = algo, scale, resolve(device)
        net = NETS[algo](scale=scale)
        if params is None:
            reset_flax(net, torch.Generator().manual_seed(seed))
        else:
            net.load_state_dict(check_state(net, params, algo))
        self.net = net.to(self.dev)
        self._opt = None

    # ---- inference ----

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 1, h, w) -> the prediction with the bilinear base (LapSRN
        adds its pyramid bases inside)."""
        out = self.net(x)
        if self.algo != "lapsrn":  # residual learning
            N, _, h, w = x.shape
            out = out + image_resize(x, (N, 1, h * self.scale, w * self.scale), "bilinear")
        return out

    def upsample(self, img) -> torch.Tensor:
        """(H, W) in [0, 1] -> (scale*H, scale*W) on the model's device."""
        x = to_device(img, self.dev)[None, None]
        with torch.no_grad(), f32_matmul_precision():
            return torch.clamp(self._forward(x)[0, 0], 0.0, 1.0)

    @staticmethod
    def upsample_bicubic(img, scale: int) -> torch.Tensor:
        """Bicubic (Keys, a = -0.5) x scale where img lies (host data on
        the CPU)."""
        x = img.to(torch.float32) if isinstance(img, torch.Tensor) else torch.as_tensor(np.asarray(img, np.float32))
        return image_resize(x, (x.shape[0] * scale, x.shape[1] * scale), "cubic")

    # ---- training ----

    def init_training(self, lr: float = 1e-3):
        self._opt = Adam(self.net.parameters(), lr)

    def train_step(self, lr_batch, hr_batch) -> float:
        """lr_batch (N, h, w, 1), hr_batch (N, h*scale, w*scale, 1) (the
        twin's layout): one Adam step on the mean squared error; the loss
        as a host float (one wait for the device, as the twin's)."""
        lr_t = to_device(lr_batch, self.dev).permute(0, 3, 1, 2)
        hr_t = to_device(hr_batch, self.dev).permute(0, 3, 1, 2)
        with f32_matmul_precision(), deterministic():
            self._opt.zero_grad()
            loss = torch.mean((self._forward(lr_t) - hr_t) ** 2)
            loss.backward()
            self._opt.step()
        return float(loss.detach())

    # ---- persistence (readModel/setModel contract) ----

    def save_model(self, path: str):
        """The twin's npz: its parameter tree's key paths, kernels HWIO,
        with __algo__ and __scale__."""
        arrays = {_flax_key(p): v for p, v in _flat(state_dict_to_flax(self.net.state_dict()))}
        arrays["__algo__"] = np.array(self.algo)
        arrays["__scale__"] = np.array(self.scale)
        np.savez(path, **arrays)

    def read_model(self, path: str):
        """Weights from an npz of either package (the keys this model's
        parameters have)."""
        data = np.load(path, allow_pickle=False)
        tree: dict = {}
        for p, _ in _flat(state_dict_to_flax(self.net.state_dict())):
            node = tree
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = data[_flax_key(p)]
        self.net.load_state_dict(flax_to_state_dict(tree, self.dev))
        return self


def _crop(hr, s: int, dev) -> torch.Tensor:
    hr = to_device(hr, dev)
    H, W = (hr.shape[0] // s) * s, (hr.shape[1] // s) * s
    return hr[:H, :W]


def evaluate_psnr_ssim(model: DnnSuperRes, hr_images) -> tuple[float, float]:
    """PSNR/SSIM of model.upsample against ground-truth HR images whose LR
    inputs are the reference benchmark's protocol (bicubic downsampling by
    the model scale), on the model's device (dnn_superres/README.md:74-82)."""
    from opencv_contrib_tpu_torch.quality import psnr, ssim

    ps, ss = [], []
    s = model.scale
    for hr in hr_images:
        hr = _crop(hr, s, model.dev)
        with f32_matmul_precision():
            lr = image_resize(hr, (hr.shape[0] // s, hr.shape[1] // s), "cubic")
        out = model.upsample(lr)
        ps.append(float(psnr(out, hr)))
        ss.append(float(ssim(out, hr)))
    return float(np.mean(ps)), float(np.mean(ss))


def evaluate_bicubic(hr_images, scale: int, device="cuda") -> tuple[float, float]:
    """Bicubic baseline row of the same benchmark, on `device` (tensors
    stay where they lie)."""
    from opencv_contrib_tpu_torch.quality import psnr, ssim

    dev = resolve(device)
    ps, ss = [], []
    for hr in hr_images:
        hr = _crop(hr, scale, hr.device if isinstance(hr, torch.Tensor) else dev)
        with f32_matmul_precision():
            lr = image_resize(hr, (hr.shape[0] // scale, hr.shape[1] // scale), "cubic")
            out = DnnSuperRes.upsample_bicubic(lr, scale)
        ps.append(float(psnr(out, hr)))
        ss.append(float(ssim(out, hr)))
    return float(np.mean(ps)), float(np.mean(ss))
