"""Extended image processing (ximgproc-module parity): the edge-aware sparse
match interpolator (`interp`) that the dense-flow remainder densifies with."""
