"""Shape matching + transformation (the port of opencv_contrib_tpu/shape:
shape-module parity).

Reference anchors: shape/src — shape_context.cpp (ShapeContextDistance
Extractor), tps_trans.cpp (ThinPlateSplineShapeTransformer), aff_trans.cpp
(AffineTransformer), haus_dis.cpp (HausdorffDistanceExtractor), hist_cost.cpp
(chi2/EMD-L1 histogram costs).
"""

from opencv_contrib_tpu_torch.shape.distances import (chi2_cost, hausdorff_distance, shape_context_descriptor,
                                                      shape_context_distance)
from opencv_contrib_tpu_torch.shape.extra import (
    affine_apply,
    affine_fit,
    affine_transform_cost,
    emd_1d,
    emd_histogram_cost,
    emd_l1_grid,
    emd_sinkhorn,
)
from opencv_contrib_tpu_torch.shape.tps import tps_apply, tps_fit

__all__ = [
    "emd_1d", "emd_l1_grid", "emd_sinkhorn", "emd_histogram_cost",
    "affine_fit", "affine_apply", "affine_transform_cost",
    "hausdorff_distance",
    "chi2_cost",
    "shape_context_descriptor",
    "shape_context_distance",
    "tps_fit",
    "tps_apply",
]
