"""Fixed-capacity keypoint arrays: every field padded to a capacity K with a
validity mask (the port of opencv_contrib_tpu/features/keypoints.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Keypoints(NamedTuple):
    """Structure-of-arrays keypoint set, capacity K."""

    y: torch.Tensor  # (K,) float row coordinate
    x: torch.Tensor  # (K,) float col coordinate
    scale: torch.Tensor  # (K,) float characteristic scale (sigma-like)
    angle: torch.Tensor  # (K,) float orientation, radians
    response: torch.Tensor  # (K,) float detector response
    valid: torch.Tensor  # (K,) bool

    @property
    def capacity(self) -> int:
        return self.y.shape[-1]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)

    def yx(self) -> torch.Tensor:
        return torch.stack([self.y, self.x], dim=-1)

    def xy(self) -> torch.Tensor:
        return torch.stack([self.x, self.y], dim=-1)


def empty(capacity: int, device="cpu") -> Keypoints:
    z = torch.zeros(capacity, dtype=torch.float32, device=device)
    return Keypoints(z, z, torch.ones_like(z), z, z, torch.zeros(capacity, dtype=torch.bool, device=device))


def from_arrays(y, x, scale=None, angle=None, response=None, valid=None, device=None) -> Keypoints:
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    dev = y.device
    k = y.shape[-1]

    def f32(v, fill):
        if v is None:
            return torch.full((k,), fill, dtype=torch.float32, device=dev)
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    valid = (torch.ones(k, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool, device=dev))
    return Keypoints(y, x, f32(scale, 1.0), f32(angle, 0.0), f32(response, 1.0), valid)
