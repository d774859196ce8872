"""2D curve plotting to images (the port of opencv_contrib_tpu/plot;
plot-module parity: Plot2d, plot.hpp)."""

from opencv_contrib_tpu_torch.plot.render import plot2d

__all__ = ["plot2d"]
