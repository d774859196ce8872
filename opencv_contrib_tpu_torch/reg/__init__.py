"""Pixel-based parametric image registration (the port of
opencv_contrib_tpu/reg).

Reference anchors: reg/src: MapperGradShift, MapperGradEuclid,
MapperGradSimilar, MapperGradAffine, MapperGradProj (mappergrad*.cpp) and
the Map{Shift,Affine,Projec} result types; MapperPyramid for coarse-to-fine.

One Gauss-Newton driver over a model-specific warp parameterization;
Jacobians by forward-mode autodiff of the warp (`torch.func.jacfwd`);
coarse-to-fine over the pyramid (the pyrdown kernel on the card); each
level's iterations step in Python with no host read.
"""

from opencv_contrib_tpu_torch.reg.mapper import MODELS, register_pyramid, warp_with_params

__all__ = ["register_pyramid", "warp_with_params", "MODELS"]
