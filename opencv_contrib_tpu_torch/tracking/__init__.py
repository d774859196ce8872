"""Single- and multi-object trackers (the port of opencv_contrib_tpu/tracking).

Parity targets (reference anchors):
- MOSSE correlation filter (tracking/src/mosseTracker.cpp)
- KCF kernelized correlation filter (tracking/src/trackerKCF.cpp:74)
- CSRT channel/spatial reliability DCF (tracking/src/trackerCSRT.cpp:28)
- MedianFlow forward-backward LK voting (trackerMedianFlow.cpp)
- MIL online multiple-instance boosting (trackerMIL.cpp, feature.cpp)
- TLD tracking-learning-detection cascade (tld*.cpp)
- TrackerByMatching multi-target pipeline + Kuhn-Munkres assignment
  (tracking_by_matching.cpp, kuhn_munkres.cpp)
- Unscented/linear Kalman filters (kalman_filters.hpp)

The trackers are functions on NamedTuple states of tensors on the image's
device; a step reads nothing back to the host, except the Hungarian
assignment (a host algorithm, as in the reference) and the Siamese
tracker's host box. Random draws come from `torch.Generator`s. MIL's and
Boosting's Haar features take one batched integral launch a set of patches;
MedianFlow's and TLD's LK pyramids launch pyrdown.
"""

from opencv_contrib_tpu_torch.tracking import (
    boosting,
    correlation,
    csrt,
    kalman,
    matching,
    medianflow,
    mil,
    multitracker,
    siam,
    tld,
    twist,
)

__all__ = ["boosting", "correlation", "csrt", "kalman", "matching", "medianflow",
           "mil", "multitracker", "siam", "tld", "twist"]
