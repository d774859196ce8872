"""Line detection and binary line descriptors (the port of
opencv_contrib_tpu/line_descriptor).

Reference anchors: LSDDetector / BinaryDescriptor (LBD over EDLine segments,
line_descriptor/include/opencv2/line_descriptor/descriptor.hpp:182,272) and
BinaryDescriptorMatcher (:290, multi-index hashing: mih.py).

Segments come from the Hough accumulator (peaks, then segment ends from the
extent of on-line edge support); the LBD-class descriptor aggregates
oriented gradient statistics in bands parallel to the line.
"""

from opencv_contrib_tpu_torch.line_descriptor.lines import detect_line_segments, lbd_describe
from opencv_contrib_tpu_torch.line_descriptor.mih import (
    MIHIndex,
    lbd_binarize,
    mih_build,
    mih_knn_match,
    mih_radius_match,
)

__all__ = ["detect_line_segments", "lbd_describe", "lbd_binarize",
           "mih_build", "mih_knn_match", "mih_radius_match", "MIHIndex"]
