"""2D phase unwrapping (the port of opencv_contrib_tpu/phase_unwrapping).

Reference anchor: HistogramPhaseUnwrapping
(phase_unwrapping/src/histogramphaseunwrapping.cpp), quality-guided
unwrapping. Here, as in the JAX package: the unweighted least-squares DCT
solver (Ghiglia-Romero), the same Poisson problem solved by one global
transform instead of a sequential quality-sorted flood fill.
"""

from opencv_contrib_tpu_torch.phase_unwrapping.unwrap import unwrap_phase_dct, wrap

__all__ = ["unwrap_phase_dct", "wrap"]
