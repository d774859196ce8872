"""1-D signal processing (the port of opencv_contrib_tpu/signal;
signal-module parity: signal_resample.cpp)."""

from opencv_contrib_tpu_torch.signal.resample import resample_signal

__all__ = ["resample_signal"]
