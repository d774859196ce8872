"""Full-f32 matrix products on the card.

Reduced-precision products (TF32 keeps 10 mantissa bits) put a floor under
geometry: a 3x3 rotation product carries ~1e-3 relative error, which a focal
length turns into pixels, and bundle adjustment stalls on it. `f32_matmuls`
pins full f32 for matmuls and cuDNN inside the decorated call and restores
the previous settings after it.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def f32_matmul_precision():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        # the precision setting also writes allow_tf32, so restore it first
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]


def f32_matmuls(fn):
    """Run `fn` with full-f32 matrix products."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32_matmul_precision():
            return fn(*args, **kwargs)

    return wrapped
