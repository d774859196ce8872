"""Image quality assessment (the port of opencv_contrib_tpu/quality:
QualityMSE / PSNR / SSIM / GMSD from utils.metrics, re-exported here as the
JAX package does, and BRISQUE's natural-scene features with the untrained
`no_reference_score`). The trained BRISQUE head (`brisque_svr`) is not
ported yet."""

from opencv_contrib_tpu_torch.quality.brisque import brisque_features, mscn_coefficients, no_reference_score
from opencv_contrib_tpu_torch.utils.metrics import gmsd, mse, psnr, ssim

__all__ = ["mse", "psnr", "ssim", "gmsd", "brisque_features", "mscn_coefficients", "no_reference_score"]
