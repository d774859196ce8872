"""Image-processing primitives: sampling, filters, integral images,
histograms, morphology, connected components and template matching;
ops.cuda holds the hand-written kernels."""

from opencv_contrib_tpu_torch.ops import ccl, filters, histogram, image, integral, morphology, template_match

__all__ = ["ccl", "filters", "histogram", "image", "integral", "morphology", "template_match"]
