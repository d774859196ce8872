"""Incremental structure-from-motion — the port of opencv_contrib_tpu/sfm:
tracks as a dense (views x tracks) array, each solver stage (RANSAC init,
PnP resection, triangulation, bundle adjustment) a batched tensor program on
the device, and the fixpoint control flow on the host."""

from opencv_contrib_tpu_torch.sfm import pairing, pipeline, tracks

__all__ = ["pairing", "pipeline", "tracks"]
