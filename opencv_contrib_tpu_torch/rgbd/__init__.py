"""KinectFusion: depth frames, ICP, the TSDF volume and the tick."""
