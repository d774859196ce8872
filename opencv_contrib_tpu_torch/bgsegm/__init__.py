"""Background subtraction (the port of opencv_contrib_tpu/bgsegm:
bgsegm-module parity).

Reference anchors: bgsegm/include/opencv2/bgsegm.hpp —
BackgroundSubtractorMOG (:62, gaussian mixtures), CNT (:250, pixel
stability counters), GMG (:125), GSOC/LSBP (sample consensus); plus a
synthetic sequence generator (SyntheticSequenceGenerator) used by its tests.

Each subtractor keeps its per-pixel model in a NamedTuple of tensors on the
frame's device, and one `*_apply` step updates every pixel at once with no
host read. GSOC and LSBP draw their replacement masks from the
`torch.Generator` their state holds.
"""

from opencv_contrib_tpu_torch.bgsegm.cnt import CntState, cnt_apply, cnt_create
from opencv_contrib_tpu_torch.bgsegm.gmg import GmgState, gmg_apply, gmg_create
from opencv_contrib_tpu_torch.bgsegm.gsoc import (
    GsocState, LsbpState, gsoc_apply, gsoc_create, lsbp_apply, lsbp_create, lsbp_descriptor,
)
from opencv_contrib_tpu_torch.bgsegm.mog import MogState, mog_apply, mog_create
from opencv_contrib_tpu_torch.bgsegm.synthetic import synthetic_sequence

__all__ = [
    "MogState", "mog_create", "mog_apply",
    "CntState", "cnt_create", "cnt_apply",
    "GmgState", "gmg_create", "gmg_apply",
    "GsocState", "gsoc_create", "gsoc_apply",
    "LsbpState", "lsbp_create", "lsbp_apply", "lsbp_descriptor",
    "synthetic_sequence",
]
