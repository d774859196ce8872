"""Alpha matting (the port of opencv_contrib_tpu/alphamat; alphamat-module
parity).

Reference anchor: cv::alphamat::infoFlow (alphamat/src/infoflow.cpp —
information-flow matting: per-pixel affinities + a global sparse linear
solve with trimap constraints).

The matting Laplacian's linear system is solved with conjugate gradient
where the operator is a local windowed affinity stencil (rolls) — the same
structure as the reference's sparse solve without building the sparse
matrix.
"""

from opencv_contrib_tpu_torch.alphamat.infoflow import info_flow, info_flow_nonlocal

__all__ = ["info_flow", "info_flow_nonlocal"]
