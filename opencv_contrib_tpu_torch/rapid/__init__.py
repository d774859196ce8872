"""RAPID: silhouette-based 3D edge tracking (the port of
opencv_contrib_tpu/rapid).

Parity targets (reference anchors, rapid/src/rapid.cpp +
include/opencv2/rapid.hpp):
- extractControlPoints: sample 3D points along model silhouette edges and
  project them with the current pose
- extractLineBundle: sample image intensity along short search lines normal
  to the projected edges
- findCorrespondencies: strongest gradient along each search line
- rapid()/Tracker (Rapid, OLSTracker, GOSTracker): iterate search + pose
  refinement

The whole line bundle is one bilinear gather (n_points x n_samples); the
per-point 1D edge search is an argmax over that matrix; pose refinement is
the Gauss-Newton resection (mvg.resection.refine_pose) on the displaced
correspondences.
"""

from opencv_contrib_tpu_torch.rapid.tracker import (
    extract_control_points,
    extract_line_bundle,
    find_correspondencies,
    rapid_step,
    track,
)

__all__ = [
    "extract_control_points",
    "extract_line_bundle",
    "find_correspondencies",
    "rapid_step",
    "track",
]
