"""Signal resampling (cv::signal::resampleSignal contract): cubic-kernel
resampling of a 1-D signal to a new length (the port of
opencv_contrib_tpu/signal/resample.py, `jax.image.resize` through its twin
`ops.image.image_resize`)."""

from __future__ import annotations

import torch

from opencv_contrib_tpu_torch.ops.image import image_resize
from opencv_contrib_tpu_torch.utils.device import as_float


def resample_signal(x, out_length: int) -> torch.Tensor:
    """x (N,) -> (out_length,) by the Keys cubic kernel (antialiased when
    shrinking), where x lies (host data on the CPU)."""
    return image_resize(as_float(x), (out_length,), method="cubic")
