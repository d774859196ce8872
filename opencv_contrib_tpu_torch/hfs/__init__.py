"""HFS: hierarchical feature selection image segmentation (the port of
opencv_contrib_tpu/hfs).

Parity target: hfs/src/* (HfsSegment: SLIC oversegmentation ->
Felzenszwalb-style graph merging on the superpixel graph in two stages ->
final segment map). Superpixels and per-region features (mean color,
boundary gradient strength) are segment sums on the device; the sequential
union-find merge over sorted edges runs on the host, as in the reference,
which runs this stage on the CPU even in its CUDA build.
"""

from opencv_contrib_tpu_torch.hfs.segment import hfs_segment, region_adjacency, region_features

__all__ = ["hfs_segment", "region_adjacency", "region_features"]
