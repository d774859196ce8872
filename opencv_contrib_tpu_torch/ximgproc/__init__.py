"""Extended image processing (the port of opencv_contrib_tpu/ximgproc:
ximgproc-module parity).

Reference anchors (ximgproc/include/opencv2/ximgproc/):
- edge_filter.hpp: GuidedFilter (:130, in ops.filters), DTFilter (:66),
  rolling guidance, anisotropic diffusion (anisodiff.cpp), the fast global
  smoother and the rest of filters_x2
- sparse_match_interpolator.hpp: EdgeAwareInterpolator (:77), the
  densifier of the dense-flow remainder
- slic.hpp: SuperpixelSLIC (:78); SEEDS, LSC and ScanSegment superpixels
- segmentation.hpp: graph segmentation, selective search; EdgeBoxes
- fast_line_detector.hpp + structured_edge_detection.hpp: line/edge
  detection, the learned edge map (edge_forest)
- edge_drawing.hpp: ED lines and circles; Hough circles, Canny, MSER;
  ellipses (find_ellipses.hpp)
- thinning, niBlack threshold, FourierDescriptors, RidgeFilter, Radon,
  Pei-Lin, colour matching, covariance, run-length morphology
"""

from opencv_contrib_tpu_torch.ximgproc.filters_x import (
    anisotropic_diffusion,
    rolling_guidance_filter,
    dt_filter,
    niblack_threshold,
    ridge_filter,
)
from opencv_contrib_tpu_torch.ximgproc.slic import slic
from opencv_contrib_tpu_torch.ximgproc.edges import structured_edges_lite, fast_hough_lines, thinning
from opencv_contrib_tpu_torch.ximgproc.interp import edge_aware_interpolate
from opencv_contrib_tpu_torch.ximgproc.fourier import fourier_descriptors
from opencv_contrib_tpu_torch.ximgproc.superpixels_x import lsc, seeds
from opencv_contrib_tpu_torch.ximgproc.segmentation import edge_boxes, graph_segment, selective_search
from opencv_contrib_tpu_torch.ximgproc.edline import ed_circles, ed_lines
from opencv_contrib_tpu_torch.ximgproc.hough_mser import canny, hough_circles, mser
from opencv_contrib_tpu_torch.ximgproc.filters_x2 import (
    fast_global_smoother,
    disparity_wls_filter,
    l0_smooth,
    bilateral_texture_filter,
    joint_bilateral_filter,
    weighted_median_filter,
    deriche_gradient_x,
    deriche_gradient_y,
    paillou_gradient_x,
    paillou_gradient_y,
    edge_preserving_filter,
    adaptive_manifold_filter,
    fast_bilateral_solver,
)
from opencv_contrib_tpu_torch.ximgproc.transforms_x import (
    radon_transform,
    peilin_normalization,
    color_match_template,
    covariance_estimation,
    erode_fast,
    dilate_fast,
    scan_segment,
    find_ellipses,
    conic_to_ellipse,
)

__all__ = [
    "anisotropic_diffusion",
    "rolling_guidance_filter",
    "dt_filter",
    "niblack_threshold",
    "ridge_filter",
    "slic",
    "structured_edges_lite",
    "fast_hough_lines",
    "thinning",
    "edge_aware_interpolate",
    "fourier_descriptors",
]
