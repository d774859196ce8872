"""Saliency detection (the port of opencv_contrib_tpu/saliency).

Reference anchors: saliency/src — StaticSaliencySpectralResidual
(staticSaliencySpectralResidual.cpp), StaticSaliencyFineGrained
(staticSaliencyFineGrained.cpp), MotionSaliencyBinWangApr2014 (a running
temporal model here) and ObjectnessBING (the normed-gradient objectness
score over windows of quantized sizes).
"""

from opencv_contrib_tpu_torch.saliency.bing import objectness_boxes, score_windows, train_template
from opencv_contrib_tpu_torch.saliency.motion import MotionSaliency, motion_apply, motion_create
from opencv_contrib_tpu_torch.saliency.static import fine_grained, spectral_residual

__all__ = [
    "spectral_residual", "fine_grained", "MotionSaliency", "motion_create",
    "motion_apply", "objectness_boxes", "score_windows", "train_template",
]
