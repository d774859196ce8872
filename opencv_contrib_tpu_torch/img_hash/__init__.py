"""Perceptual image hashing (the port of opencv_contrib_tpu/img_hash).

Reference anchors: img_hash/src — average_hash.cpp, block_mean_hash.cpp,
phash.cpp, color_moment_hash.cpp, radial_variance_hash.cpp,
marr_hildreth_hash.cpp; all `: public ImgHashBase` with compute/compare.

Binary hashes are bool tensors, the colour-moment and radial-variance
hashes float vectors; `hamming_compare` is the binary hashes' metric.
"""

from opencv_contrib_tpu_torch.img_hash.hashes import (
    average_hash,
    block_mean_hash,
    color_moment_hash,
    hamming_compare,
    marr_hildreth_hash,
    phash,
    radial_variance_hash,
)

__all__ = [
    "average_hash",
    "block_mean_hash",
    "phash",
    "color_moment_hash",
    "radial_variance_hash",
    "marr_hildreth_hash",
    "hamming_compare",
]
