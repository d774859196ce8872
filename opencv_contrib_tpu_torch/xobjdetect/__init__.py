"""Boosted sliding-window object detection (the port of
opencv_contrib_tpu/xobjdetect: xobjdetect + cudaobjdetect roles).

Parity targets (reference anchors):
- xobjdetect: WBDetector (xobjdetect/src/wbdetector.cpp) — WaldBoost over
  integral channel features (ICF) with early rejection.
- cudaobjdetect: cuda::HOG (cudaobjdetect/src/hog.cpp + cuda/hog.cu) —
  HOG descriptor + linear SVM over a multi-scale sliding-window grid.

Channels are computed once per image; all windows at a scale are scored as
one batched gather + matmul; WaldBoost's sequential rejection is a mask on
the running sum of every window's stump responses. WaldBoost's eight
channel tables are one batched launch of the integral kernel on the card.
"""

from opencv_contrib_tpu_torch.xobjdetect import hog, waldboost

__all__ = ["hog", "waldboost"]
