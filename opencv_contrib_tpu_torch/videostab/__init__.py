"""Video stabilization (the port of opencv_contrib_tpu/videostab).

Reference anchor: the StabilizerBase pipeline (videostab/include/opencv2/
videostab/stabilizer.hpp:66: motion estimation -> trajectory smoothing ->
wobble-free warping; MotionEstimatorRansacL2, GaussianMotionFilter).

Per-pair global motion by `reg.register_pyramid` (the pyrdown kernel
builds its pyramids on the card), trajectory accumulation and Gaussian
smoothing in float64, inverse-compensation warps; RANSAC motion, the
L1-optimal path, deblurring, inpainting and wobble suppression beside it.
"""

from opencv_contrib_tpu_torch.videostab.extra import (
    calc_blurriness,
    color_average_inpaint,
    consistent_mosaic_inpaint,
    lp_stabilize_trajectory,
    ransac_motion,
    weighting_deblur,
    wobble_suppress,
)
from opencv_contrib_tpu_torch.videostab.stabilizer import estimate_motions, smooth_trajectory, stabilize

__all__ = ["estimate_motions", "smooth_trajectory", "stabilize",
           "ransac_motion", "lp_stabilize_trajectory", "calc_blurriness",
           "weighting_deblur", "color_average_inpaint",
           "consistent_mosaic_inpaint", "wobble_suppress"]
