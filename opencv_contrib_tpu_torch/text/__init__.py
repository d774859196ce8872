"""Scene-text detection (the port of opencv_contrib_tpu/text): the stroke
width transform detector (`swt`, text/src/swt_text_detection.cpp), the piece
of the text module that ximgproc's line, Hough and MSER detectors import
(its `_edges`). The ER filter and the OCR heads are not ported."""

from opencv_contrib_tpu_torch.text import swt

__all__ = ["swt"]
