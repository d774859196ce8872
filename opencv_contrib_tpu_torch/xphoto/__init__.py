"""Computational photography (the port of opencv_contrib_tpu/xphoto: the
white balance family, DCT denoising, diffusion inpainting, oil painting,
BM3D and the learning-based white balance)."""

from opencv_contrib_tpu_torch.xphoto.white_balance import grayworld_wb, simple_wb
from opencv_contrib_tpu_torch.xphoto.denoise import dct_denoise
from opencv_contrib_tpu_torch.xphoto.artistic import oil_painting
from opencv_contrib_tpu_torch.xphoto.inpaint import inpaint_diffusion
from opencv_contrib_tpu_torch.xphoto.bm3d import bm3d, bm3d_denoise, bm3d_denoise_step2
from opencv_contrib_tpu_torch.xphoto.learning_wb import fit_wb_model, learning_wb, wb_features

__all__ = ["simple_wb", "grayworld_wb", "dct_denoise", "oil_painting", "inpaint_diffusion", "bm3d", "bm3d_denoise",
           "bm3d_denoise_step2", "fit_wb_model", "learning_wb", "wb_features"]
