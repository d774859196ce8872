"""3D surface matching (the port of opencv_contrib_tpu/surface_matching).

Reference anchors: PPF3DDetector::{trainModel, match}
(surface_matching/include/opencv2/surface_matching/ppf_match_3d.hpp:97,131,
141: 4D point-pair-feature hashing + pose voting, Pose3D clustering) and
the standalone ICP (icp.hpp:80 registerModelToScene: point-to-plane,
pyramid, sample picking; independent of the KinFu ICP).

PPFs for all sampled pairs are one batched computation; the reference's
hash table becomes quantized-feature keys with a stable sort and
searchsorted joins; voting is an accumulating scatter over (scene
reference point, model reference point, angle) bins.
"""

from opencv_contrib_tpu_torch.surface_matching.icp3d import register_model_to_scene
from opencv_contrib_tpu_torch.surface_matching.ppf import PPFModel, compute_ppf_features, train_model
from opencv_contrib_tpu_torch.surface_matching.ppf import match as ppf_match

__all__ = ["compute_ppf_features", "PPFModel", "train_model", "ppf_match", "register_model_to_scene"]
