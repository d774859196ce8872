"""The flax layers the learned models are built from, as torch modules.

Each network of `models`, `text.crnn` and `wechat_qrcode.learned` names its
submodules with flax's automatic names (`Conv_0`, `Dense_1`, `PReLU_2`,
`FireLite_0`, `GRUCell_1`), so a module's state-dict keys are the paths of
its twin's parameter tree and one converter serves every network
(`flax_to_state_dict`, `state_dict_to_flax`).

- `Conv`: flax's `nn.Conv` with its "SAME" padding. For a stride-2 kernel
  on an even side XLA pads (0, 1), not (1, 1); a 2 x 2 stride-1 kernel pads
  (0, 1) as well. Weights OIHW.
- `Dense`: `nn.Dense` as an `nn.Linear` (weight (out, in)).
- `PReLU`: `nn.PReLU`, one scalar slope that starts at 0.01 (torch's
  starts at 0.25), `where(x >= 0, x, a x)` as flax computes it.
- `GRUCell`: `nn.GRUCell` written out: input projections `ir`, `iz`,
  `in` with biases, hidden projections `hr`, `hz` without and `hn` with
  one (torch's GRU has a hidden bias on r and z too, which would train).
- `reset_flax(module, gen)`: flax's initialisers drawn from a
  `torch.Generator`: kernels truncated lecun-normal, the GRU's hidden
  kernels orthogonal, biases zero, PReLU slopes 0.01.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LECUN_TRUNC = 0.87962566103423978  # the stddev of a standard normal truncated to (-2, 2)


def same_pad(x: torch.Tensor, k, stride=1) -> torch.Tensor:
    """flax / XLA "SAME" padding of (..., H, W) for a kernel k (int or (kh,
    kw)) at `stride`: out = ceil(n / stride), the total pad split with its
    smaller half before."""
    kh, kw = (k, k) if isinstance(k, int) else k
    sh, sw = (stride, stride) if isinstance(stride, int) else stride

    def pads(n, kk, s):
        total = max((-(-n // s) - 1) * s + kk - n, 0)
        return total // 2, total - total // 2

    (top, bottom), (left, right) = pads(x.shape[-2], kh, sh), pads(x.shape[-1], kw, sw)
    return F.pad(x, (left, right, top, bottom))


class Conv(nn.Conv2d):
    """flax's `nn.Conv` (padding "SAME", or "VALID") on NCHW tensors."""

    def __init__(self, cin: int, cout: int, k, stride=1, padding: str = "SAME"):
        super().__init__(cin, cout, k, stride=stride)
        self.same = padding == "SAME"

    def forward(self, x):
        if self.same:
            x = same_pad(x, self.kernel_size, self.stride)
        return super().forward(x)


class Dense(nn.Linear):
    """flax's `nn.Dense`."""


class PReLU(nn.Module):
    """flax's `nn.PReLU`: one slope, 0.01 at the start."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


def leaky_relu(x, slope: float):
    """`nn.leaky_relu` as flax computes it (the gradient at 0 is 1)."""
    return torch.where(x >= 0, x, slope * x)


class GRUCell(nn.Module):
    """flax's `nn.GRUCell` (sigmoid gates, tanh candidate):
    r = s(ir x + hr h), z = s(iz x + hz h), n = tanh(in x + r * hn h),
    h' = (1 - z) n + z h."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(cin, features))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, Dense(features, features, bias=bias))
        self.features = features

    def run(self, xs: torch.Tensor) -> torch.Tensor:
        """The cell over xs (B, T, F_in) from a zero state, forward in T
        (flax's `nn.RNN`): the states (B, T, features). The input
        projections of all T steps are one product each."""
        m = self._modules
        xr, xz, xn = m["ir"](xs), m["iz"](xs), m["in"](xs)
        h = xs.new_zeros((xs.shape[0], self.features))
        out = []
        for t in range(xs.shape[1]):
            r = torch.sigmoid(xr[:, t] + m["hr"](h))
            z = torch.sigmoid(xz[:, t] + m["hz"](h))
            n = torch.tanh(xn[:, t] + r * m["hn"](h))
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out, 1)


def lecun_normal_(w: torch.Tensor, gen: torch.Generator):
    """flax's lecun_normal into `w` from `gen`: a standard normal truncated
    to (-2, 2), scaled to variance 1 / fan_in."""
    fan_in = w[0].numel()  # OIHW: I * kh * kw; (out, in): in
    t = torch.empty(w.shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.copy_(t * (math.sqrt(1.0 / fan_in) / LECUN_TRUNC))


def reset_flax(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """flax's initialisation of every layer of `module`, in registration
    order, from `gen`; returns `module`."""
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (Conv, Dense)):
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("hr", "hz", "hn"):
                    t = torch.empty(m.weight.shape)
                    nn.init.orthogonal_(t, generator=gen)
                    m.weight.copy_(t)
                else:
                    lecun_normal_(m.weight, gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, PReLU):
                m.negative_slope.fill_(0.01)
    return module


def flax_to_state_dict(tree, device="cpu") -> dict:
    """A flax parameter tree (nested dicts of JAX or numpy arrays, with or
    without the outer "params") as a state dict of the module whose
    submodules carry the flax names: Conv kernels HWIO -> OIHW, Dense
    kernels (in, out) -> (out, in), biases and PReLU slopes as they are;
    float32 on `device`."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                out[f"{prefix}weight"] = a
            elif k in ("bias", "negative_slope"):
                out[f"{prefix}{k}"] = a
            else:
                raise ValueError(f"unknown flax leaf {prefix}{k}")

    walk(tree, "")
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device) for k, v in out.items()}


def state_dict_to_flax(state: dict) -> dict:
    """The inverse of `flax_to_state_dict`: {"params": nested numpy tree}."""
    tree: dict = {}
    for key, t in state.items():
        *path, leaf = key.split(".")
        a = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            leaf, a = "kernel", (a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(a)
    return {"params": tree}


def check_state(module: nn.Module, state: dict, what: str) -> dict:
    """`state` if its keys and shapes are `module`'s, else raise."""
    own = module.state_dict()
    if set(own) != set(state):
        raise ValueError(f"{what}: parameters {sorted(state)} != {sorted(own)}")
    bad = [k for k in own if tuple(own[k].shape) != tuple(state[k].shape)]
    if bad:
        raise ValueError(f"{what}: shapes differ at {bad}")
    return state
