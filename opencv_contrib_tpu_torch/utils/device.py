"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """`device` as a torch.device. "cuda" on a machine without a card
    raises: nothing falls back to the CPU, which a caller asks for by name."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the entry points run on the GPU; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return d
