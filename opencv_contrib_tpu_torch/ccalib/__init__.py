"""Custom calibration (the port of opencv_contrib_tpu/ccalib).

Reference anchors: omnidirectional (Mei unified-sphere) camera model:
omnidir::projectPoints (ccalib/include/opencv2/ccalib/omnidir.hpp:103),
initUndistortRectifyMap (:141), undistortImage (:156), calibrate (:176);
the random-pattern corner finder (randpattern.cpp). MultiCameraCalibration's
camera-pattern pose graph (multicalib.hpp:141) maps onto rgbd.posegraph +
mvg.resection and is exercised through those modules.
"""

from opencv_contrib_tpu_torch.ccalib.omnidir import (
    calibrate_xi,
    project_points_omni,
    undistort_image_omni,
    undistort_points_omni,
)
from opencv_contrib_tpu_torch.ccalib.random_pattern import find_correspondences, generate_pattern

__all__ = [
    "project_points_omni", "undistort_points_omni", "undistort_image_omni",
    "calibrate_xi", "find_correspondences", "generate_pattern",
]
