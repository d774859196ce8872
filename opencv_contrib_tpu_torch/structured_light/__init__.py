"""Structured light (the port of opencv_contrib_tpu/structured_light).

Reference anchors: GrayCodePattern
(structured_light/src/graycodepattern.cpp: generate + decode with
white/black thresholding) and SinusoidalPattern PSP / FTP / FAPS
(sinusoidalpattern.cpp), with the phase unwrapped by phase_unwrapping.
"""

from opencv_contrib_tpu_torch.structured_light.graycode import decode_graycode, generate_graycode_patterns
from opencv_contrib_tpu_torch.structured_light.sinusoidal import compute_psp_phase, generate_psp_patterns

__all__ = [
    "generate_graycode_patterns",
    "decode_graycode",
    "generate_psp_patterns",
    "compute_psp_phase",
]
