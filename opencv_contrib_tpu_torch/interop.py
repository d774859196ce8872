"""Carry state between the JAX package and this one as numpy arrays.

The port has no learned weights: its state is the NamedTuples (Keypoints,
Matches, BAProblem, BAResult, the sparse BA's SparseBAProblem,
SparseBAResult and ObsBuckets, KinFu's TSDFVolume and DepthFrame, the
hashed-block volume's HashTSDF, the pose graph's PoseGraph, the colored
volume's ColoredTSDFVolume (which nests a TSDFVolume), the RANSAC's
RansacResult, the 5k-view driver's device-resident MapState, and DynaFu's
WarpField), with the same class names, field names and field order in both
packages. `from_numpy` turns such a tuple, its fields read as
numpy arrays (anything `np.asarray` takes), into this package's tuple of
tensors; `to_numpy` goes the other way.

The host-side SfM state, `sfm.tracks.TracksTensor`,
`sfm.pipeline.Reconstruction`, and the 5k-view driver's
`sfm.pipeline_scale.SparseTracks` and `SequentialReconstruction`, holds
host numpy arrays in both packages, with the same fields: it crosses as it
is and needs no conversion. So do the large-scale KinFu's
`rgbd.submap.Submap` (its pose and constraints are host numpy; its volume
crosses by `from_numpy`) and `rgbd.submap.LargeKinFuParams`.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ba.bundle import BAProblem, BAResult
from opencv_contrib_tpu_torch.ba.sparse import ObsBuckets, SparseBAProblem, SparseBAResult
from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.features.match import Matches
from opencv_contrib_tpu_torch.mvg.robust import RansacResult
from opencv_contrib_tpu_torch.rgbd.colored_tsdf import ColoredTSDFVolume
from opencv_contrib_tpu_torch.rgbd.frame import DepthFrame
from opencv_contrib_tpu_torch.rgbd.hash_tsdf import HashTSDF
from opencv_contrib_tpu_torch.rgbd.posegraph import PoseGraph
from opencv_contrib_tpu_torch.rgbd.tsdf import TSDFVolume
from opencv_contrib_tpu_torch.rgbd.warpfield import WarpField
from opencv_contrib_tpu_torch.sfm.pipeline_scale import MapState

TUPLES = {cls.__name__: cls for cls in (Keypoints, Matches, BAProblem, BAResult, SparseBAProblem, SparseBAResult,
                                        ObsBuckets, TSDFVolume, DepthFrame, HashTSDF, PoseGraph, ColoredTSDFVolume,
                                        RansacResult, MapState, WarpField)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_numpy(tree, device="cpu"):
    """NamedTuple / tuple / list / dict of arrays -> the same structure of
    tensors on `device`; a NamedTuple maps to this package's class of the
    same name."""
    if _is_namedtuple(tree):
        cls = TUPLES.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no counterpart for {type(tree).__name__}")
        if cls._fields != tree._fields:
            raise TypeError(f"{cls.__name__}: fields {tree._fields} != {cls._fields}")
        return cls(*(from_numpy(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(np.asarray(tree)), device=device)


def to_numpy(tree):
    """The inverse of `from_numpy`: tensors -> numpy arrays, structure kept."""
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
