"""ArUco-class fiducial markers (the port of opencv_contrib_tpu/aruco).

Reference anchors: the aruco back-compat module (aruco/src/aruco.cpp;
detection now lives in main objdetect): dictionary-based square fiducials,
detectMarkers -> (corners, ids), drawMarker / generateImageMarker.

The reference ships fixed predefined dictionaries (data tables); the port,
as the JAX package, generates dictionaries with the same recipe (random
codes with a minimum pairwise Hamming distance over all 4 rotations,
seeded).

The split is the twin's: thresholding, homography unwarp and bit sampling
are device code; candidate quad extraction (connected components + corner
picking) and the dictionary lookup are host-side scipy / numpy, the same
CPU-contour + GPU-refine split real pipelines use.
"""

from opencv_contrib_tpu_torch.aruco.markers import detect_markers, draw_marker, generate_dictionary

__all__ = ["generate_dictionary", "draw_marker", "detect_markers"]
