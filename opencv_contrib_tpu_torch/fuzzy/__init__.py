"""Fuzzy-transform image processing (the port of opencv_contrib_tpu/fuzzy;
fuzzy-module parity).

Reference anchors: fuzzy/src — F0-transform (fuzzy_F0_math.cpp),
F1-transform (fuzzy_F1_math.cpp), FT-based filtering + inpainting
(fuzzy_image.cpp ft02D_process / inpaint).
"""

from opencv_contrib_tpu_torch.fuzzy.ftransform import (
    f0_components, f0_inverse, f0_filter, f0_inpaint,
    f1_components, f1_inverse, f1_filter,
)

__all__ = ["f0_components", "f0_inverse", "f0_filter", "f0_inpaint"]
