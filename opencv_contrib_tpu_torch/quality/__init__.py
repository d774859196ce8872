"""Image quality assessment (the port of opencv_contrib_tpu/quality:
QualityMSE / PSNR / SSIM / GMSD from utils.metrics, re-exported here as the
JAX package does; BRISQUE's natural-scene features with the untrained
`no_reference_score`; and the trained BRISQUE head of `brisque_svr`, an RBF
kernel ridge regression trained in the repository on graded synthetic
distortions)."""

from opencv_contrib_tpu_torch.quality.brisque import brisque_features, mscn_coefficients, no_reference_score
from opencv_contrib_tpu_torch.quality.brisque_svr import (BrisqueModel, brisque_score, load_model, save_model,
                                                          train_brisque_model)
from opencv_contrib_tpu_torch.utils.metrics import gmsd, mse, psnr, ssim

__all__ = ["mse", "psnr", "ssim", "gmsd", "brisque_features", "mscn_coefficients", "no_reference_score",
           "BrisqueModel", "train_brisque_model", "brisque_score", "save_model", "load_model"]
