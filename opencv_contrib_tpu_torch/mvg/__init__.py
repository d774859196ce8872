"""Multiview geometry — the port of opencv_contrib_tpu/mvg: fundamental /
essential solvers, triangulation, homography, PnP resection and a batched
RANSAC."""

from opencv_contrib_tpu_torch.mvg import conditioning, fundamental, homography, resection, robust, triangulation

__all__ = ["conditioning", "fundamental", "triangulation", "homography", "resection", "robust"]
