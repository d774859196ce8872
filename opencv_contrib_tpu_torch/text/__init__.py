"""Scene-text detection and recognition (the port of opencv_contrib_tpu/text).

- SWT text detection: text/src/swt_text_detection.cpp (`swt`; ximgproc's
  line, Hough and MSER detectors import its `_edges`)
- ER filter: text/src/erfilter.cpp (`er`, the Neumann-Matas extremal
  region cascade, text/include/opencv2/text/erfilter.hpp:118-151)
- OCR heads: `ocr`, the OCRHMMDecoder / OCRBeamSearchDecoder role (glyph
  classifier, Viterbi and beam decoding; ocr_hmm_decoder.cpp,
  ocr_beamsearch_decoder.cpp)
- `crnn`: the holistic CRNN recognizer trained in the repo on synthetic
  renders (ocr_holistic.cpp's role), with optax's CTC recursion
"""

from opencv_contrib_tpu_torch.text import crnn, er, ocr, swt

__all__ = ["er", "swt", "ocr", "crnn"]
