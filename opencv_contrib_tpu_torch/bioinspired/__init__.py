"""Bio-inspired retina model (the port of opencv_contrib_tpu/bioinspired:
bioinspired-module parity).

Reference anchors: Retina (bioinspired/include/opencv2/bioinspired/
retina.hpp:162 — parvocellular detail/color pathway + magnocellular motion
pathway, photoreceptor local adaptation) and
TransientAreasSegmentationModule (transientareassegmentationmodule.hpp:122).

The retina's spatiotemporal filters are separable Gaussian stages on image
state carried frame to frame. The transient segmentation's wide context is
`ops.filters.fast_gaussian_blur`: three box passes, each one launch of the
integral kernel on the card.
"""

from opencv_contrib_tpu_torch.bioinspired.color import (
    bayer_masks,
    color_demultiplex,
    color_multiplex,
    fast_tone_mapping,
    retina_run_color,
)
from opencv_contrib_tpu_torch.bioinspired.retina import Retina, RetinaState
from opencv_contrib_tpu_torch.bioinspired.transient import TransientState, transient_create, transient_run

__all__ = ["Retina", "RetinaState", "TransientState", "transient_create", "transient_run",
           "bayer_masks", "color_multiplex", "color_demultiplex", "fast_tone_mapping",
           "retina_run_color"]
