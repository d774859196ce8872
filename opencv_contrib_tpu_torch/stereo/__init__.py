"""Stereo matching (the port of opencv_contrib_tpu/stereo).

Reference anchors: StereoBinaryBM / StereoBinarySGBM
(stereo/src/stereo_binary_{bm,sgm}.cpp), census transform descriptors
(stereo/src/descriptor.cpp), QuasiDenseStereo
(stereo/src/quasi_dense_stereo.cpp), CUDA StereoBM/SGM (cudastereo).

The cost volume is a (D, H, W) stack built by one gather of the shifted
right image; aggregation is box filtering of all D maps in one separable
pass; SGM's directional DP steps in Python over one image axis with every
line of the other axis batched, as the twin's lax.scan does.
"""

from opencv_contrib_tpu_torch.stereo.matching import (
    block_match,
    census_transform,
    cost_volume_census,
    cost_volume_sad,
    lr_consistency,
    sgm_aggregate,
    sgm_match,
)
from opencv_contrib_tpu_torch.stereo.quasi_dense import quasi_dense_stereo, zncc_volume

__all__ = [
    "census_transform",
    "cost_volume_sad",
    "cost_volume_census",
    "block_match",
    "sgm_aggregate",
    "sgm_match",
    "lr_consistency",
]
