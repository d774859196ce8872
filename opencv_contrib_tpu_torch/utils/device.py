"""Where the port's entry points run."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device) -> torch.device:
    """`device` as a torch.device. "cuda" on a machine without a card
    raises: nothing falls back to the CPU, which a caller asks for by name."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the entry points run on the GPU; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return d


def constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """Host values (a number, list or numpy array) as a tensor of `dtype` on
    `device`; to a card through pinned memory, so the copy does not make
    the host wait for the stream."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_device(x, device: torch.device) -> torch.Tensor:
    """Host data or a tensor as float32 on `device`; a host array goes
    through pinned memory, so the copy does not synchronise the stream."""
    d = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, np.float32))
    d = d.to(torch.float32)
    if d.device.type == "cpu" and device.type == "cuda":
        return d.pin_memory().to(device, non_blocking=True)
    return d.to(device)
