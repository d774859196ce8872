"""Dense RGB-D SLAM: the frame pipeline, fast ICP, the dense and hashed-block
TSDF volumes and the colored volume, KinectFusion (dense and hashed),
RGB-D odometry, the pose graph, submaps and the large-scale KinFu, normals
and depth utilities."""

from opencv_contrib_tpu_torch.rgbd import (
    colored_tsdf,
    depth_utils,
    frame,
    hash_tsdf,
    icp,
    kinfu,
    normals,
    odometry,
    posegraph,
    submap,
    tsdf,
)

__all__ = ["colored_tsdf", "depth_utils", "frame", "hash_tsdf", "icp", "kinfu", "normals", "odometry", "posegraph",
           "submap", "tsdf"]
