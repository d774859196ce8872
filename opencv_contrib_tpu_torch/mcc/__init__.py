"""Colour calibration (the port of opencv_contrib_tpu/mcc).

Reference anchors: ColorCorrectionModel (mcc/include/opencv2/mcc/ccm.hpp:360,
CCM fitting with linearization) and CCheckerDetector (checker_detector.hpp
:129, detection of the physical 4x6 chart).
"""

from opencv_contrib_tpu_torch.mcc.ccm import MACBETH_SRGB, apply_ccm, color_correction_model, fit_ccm
from opencv_contrib_tpu_torch.mcc.detector import detect_and_fit_ccm, detect_chart, find_chart_cells

__all__ = [
    "MACBETH_SRGB", "fit_ccm", "apply_ccm", "color_correction_model",
    "detect_and_fit_ccm", "detect_chart", "find_chart_cells",
]
