"""Feature detection, description and matching (the xfeatures2d-class
layer): Fast-Hessian, Harris, FAST, Star, MSD, Harris-Laplace and TBMR
detectors with affine adaptation; SURF, DAISY, box-pair, BRIEF, FREAK, LATCH,
LUCID and the learned VGG / BoostDesc descriptors; the brute-force matcher
with GMS and LOGOS filtering; PCT signatures."""

from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.features import describe, describe_x, detect, detect_x, learned, match, pct

__all__ = ["Keypoints", "detect", "detect_x", "describe", "describe_x", "learned", "match", "pct"]
