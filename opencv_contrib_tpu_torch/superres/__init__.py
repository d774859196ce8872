"""Multi-frame video super-resolution (the port of opencv_contrib_tpu/superres).

Reference anchor: BTV-L1 (superres/src/btv_l1.cpp,
createSuperResolution_BTVL1, superres.hpp:199): optical-flow-aligned
multi-frame fusion with bilateral-TV regularization and pluggable dense
flow (`flow.dis` plays DenseOpticalFlowExt's role).
"""

from opencv_contrib_tpu_torch.superres.btv import btv_l1

__all__ = ["btv_l1"]
