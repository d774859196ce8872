"""Deformable Part Models detection (the port of opencv_contrib_tpu/dpm).

Parity target: dpm/src/* (Felzenszwalb DPM cascade detector:
dpm_feature.cpp HOG pyramid, dpm_convolution.cpp filter responses,
dpm_model.cpp root+part filters with quadratic deformation costs,
distance transform part placement).

The feature pyramid is a static list of scales; filter responses are
`F.conv2d` cross-correlations; the generalized distance transform over
quadratic deformation costs is a max over static shifts of a -inf-padded
map; the parts are a Python loop over their static count; the greedy NMS
stays on the host.
"""

from opencv_contrib_tpu_torch.dpm.detector import DPMModel, detect, gdt2d, score_scale

__all__ = ["DPMModel", "detect", "gdt2d", "score_scale"]
