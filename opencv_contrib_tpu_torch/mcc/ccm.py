"""Colour correction matrix fitting (the port of opencv_contrib_tpu/mcc/ccm.py).

The fit is `torch.linalg.lstsq`: on a CUDA tensor its one LAPACK routine is QR
("gels"), which needs a full-rank system; the 24-patch chart gives one."""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.utils.device import as_float

# the standard 24-patch Macbeth ColorChecker's sRGB values (in [0, 1], row-major)
MACBETH_SRGB = (
    np.array(
        [
            [115, 82, 68], [194, 150, 130], [98, 122, 157], [87, 108, 67],
            [133, 128, 177], [103, 189, 170], [214, 126, 44], [80, 91, 166],
            [193, 90, 99], [94, 60, 108], [157, 188, 64], [224, 163, 46],
            [56, 61, 150], [70, 148, 73], [175, 54, 60], [231, 199, 31],
            [187, 86, 149], [8, 133, 161], [243, 243, 242], [200, 200, 200],
            [160, 160, 160], [122, 122, 121], [85, 85, 85], [52, 52, 52],
        ],
        np.float32,
    )
    / 255.0
)


def _linearize(rgb: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    return torch.clamp(rgb, 1e-6, 1.0) ** gamma


def _delinearize(lin: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    return torch.clamp(lin, min=0.0) ** (1.0 / gamma)


def fit_ccm(measured, reference, ccm_3x4: bool = False, gamma: float = 2.2) -> torch.Tensor:
    """Least-squares CCM in linear RGB: reference_lin ~= measured_lin @ M.
    measured / reference (N, 3) in [0, 1] sRGB; the fit runs where
    `measured` lies (host data on the CPU). Returns M (3, 3) or (4, 3)."""
    m = _linearize(as_float(measured), gamma)
    r = _linearize(as_float(reference).to(m.device), gamma)
    if ccm_3x4:
        m = torch.cat([m, torch.ones_like(m[:, :1])], dim=1)
    return torch.linalg.lstsq(m, r).solution


def apply_ccm(img, M: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Apply a fitted CCM to an sRGB image (..., 3)."""
    lin = _linearize(as_float(img), gamma)
    if M.shape[0] == 4:
        lin = torch.cat([lin, torch.ones_like(lin[..., :1])], dim=-1)
    out = torch.einsum("...i,ij->...j", lin, M.to(lin.device))
    return torch.clamp(_delinearize(out, gamma), 0.0, 1.0)


def color_correction_model(measured_patches, reference=None, gamma: float = 2.2):
    """ColorCorrectionModel: fit from the 24 measured chart patches (by
    default against the Macbeth reference). Returns (M, apply_fn)."""
    if reference is None:
        reference = MACBETH_SRGB
    M = fit_ccm(measured_patches, reference, gamma=gamma)
    return M, lambda img: apply_ccm(img, M, gamma)
