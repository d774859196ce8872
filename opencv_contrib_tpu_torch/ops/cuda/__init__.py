"""Hand-written Hopper kernels (the role `ops/pallas/` plays in the JAX
package), each beside its plain PyTorch version.

Dispatch is by the device of the input tensor: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version, any other device
raises. Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch


def use_kernel(x: torch.Tensor) -> bool:
    """True when `x` must go through the CUDA kernel, False for the plain
    version; raises for a device that has neither."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def kernels():
    """The launch-counted kernel wrappers, by name."""
    from opencv_contrib_tpu_torch.ops.cuda import histogram, matching, pyramid, reduce, remap, scan, transform

    return {"knn2": matching.knn2, "integral_image": scan.integral_image,
            "grid_scan": scan.grid_scan, "grid_reduce_vec": reduce.icp_getab,
            "pyrdown": pyramid.pyrdown, "remap": remap.remap,
            "grid_transform": transform.grid_transform, "streamed_transform": transform.streamed_transform,
            "grid_reduce": reduce.grid_reduce, "grid_histogram": histogram.grid_histogram}


def reset_launches() -> None:
    for fn in kernels().values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in kernels().items()}
