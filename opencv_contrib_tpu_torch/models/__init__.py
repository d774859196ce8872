"""Learned models (the port of opencv_contrib_tpu/models: dnn_superres and
the SqueezeDet-class detector of dnn_objdetect).

Reference anchors: DnnSuperResImpl::{readModel, setModel, upsample}
(dnn_superres/src/dnn_superres.cpp) supporting EDSR/ESPCN/FSRCNN/LapSRN,
and dnn_objdetect/src/core_detect.cpp. The reference ships pre-trained
weights as data; here the architectures are torch modules with the same
set-model/upsample API, weight save/load in the twin's npz, a training step
for fitting, and bicubic fallback. `layers` holds the flax layers they are
built from.
"""

from opencv_contrib_tpu_torch.models.dnn_superres import DnnSuperRes, ESPCN, FSRCNN

__all__ = ["DnnSuperRes", "ESPCN", "FSRCNN"]
