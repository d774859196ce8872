from opencv_contrib_tpu_torch.intensity_transform.transforms import (autoscaling, bimef, contrast_stretching,
                                                                     gamma_correction, log_transform)

__all__ = ["gamma_correction", "log_transform", "autoscaling", "contrast_stretching", "bimef"]
