from opencv_contrib_tpu_torch.xphoto.white_balance import grayworld_wb, simple_wb

__all__ = ["grayworld_wb", "simple_wb"]
