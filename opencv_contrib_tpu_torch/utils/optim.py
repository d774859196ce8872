"""Adam in optax's update order, shared by the port's in-repo trainers.

optax.adam(lr): mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the
bias corrections 1 - b^t in float32, and the step -lr (mu / c1) /
(sqrt(nu / c2) + eps), eps outside the square root (torch.optim.Adam
agrees on that but differs in where it rounds). `deterministic` keeps
cuDNN on its deterministic algorithms while a trainer runs (its default
weight-gradient algorithms may sum with atomics).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


class Adam:
    """optax.adam(lr, b1, b2, eps) over `params` (tensors with .grad)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """One update from the parameters' gradients."""
        self.count += 1
        b1, b2, lr, eps = self.b1, self.b2, self.lr, self.eps
        c1 = float(1 - np.float32(b1) ** np.float32(self.count))
        c2 = float(1 - np.float32(b2) ** np.float32(self.count))
        for p, m, v in zip(self.params, self.mu, self.nu):
            m.copy_((1 - b1) * p.grad + b1 * m)
            v.copy_((1 - b2) * p.grad ** 2 + b2 * v)
            p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + eps)))


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms inside the block, restored after."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
