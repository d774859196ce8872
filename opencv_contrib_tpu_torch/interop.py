"""Carry state between the JAX package and this one as numpy arrays.

The port's learned state is the trained BRISQUE head, the learning-based
white balance's regressor and the learned edge map's MLP. The head, `quality.brisque_svr.BrisqueModel`,
holds host numpy arrays in both packages and its npz (`save_model`,
`load_model`) is the same file: it crosses as it is. The regressor,
`xphoto.fit_wb_model`'s (F, 2) matrix, crosses by `wb_model`. The edge
map's MLP, `ximgproc.edge_forest.train`'s {"W1", "b1", "W2", "b2"}, crosses
by `edge_forest_params`.

The rest of the port's state is the NamedTuples (Keypoints,
Matches, BAProblem, BAResult, the sparse BA's SparseBAProblem,
SparseBAResult and ObsBuckets, KinFu's TSDFVolume and DepthFrame, the
hashed-block volume's HashTSDF, the pose graph's PoseGraph, the colored
volume's ColoredTSDFVolume (which nests a TSDFVolume), the RANSAC's
RansacResult, the 5k-view driver's device-resident MapState, DynaFu's
WarpField, PCT's Signature, TBMR's EllipticKeypoints and LINEMOD's Template),
with the same class names, field names and field order in both
packages. `from_numpy` turns such a tuple, its fields read as
numpy arrays (anything `np.asarray` takes), into this package's tuple of
tensors; `to_numpy` goes the other way. A field of such a tuple that holds a
Python tuple of numbers, as `Template.size` does, crosses as it is.

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
from opencv_contrib_tpu_torch.features.detect_x import EllipticKeypoints
from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.features.match import Matches
from opencv_contrib_tpu_torch.features.pct import Signature
from opencv_contrib_tpu_torch.mvg.robust import RansacResult
from opencv_contrib_tpu_torch.rgbd.colored_tsdf import ColoredTSDFVolume
from opencv_contrib_tpu_torch.rgbd.frame import DepthFrame
from opencv_contrib_tpu_torch.rgbd.hash_tsdf import HashTSDF
from opencv_contrib_tpu_torch.rgbd.linemod import Template
from opencv_contrib_tpu_torch.rgbd.posegraph import PoseGraph
from opencv_contrib_tpu_torch.rgbd.tsdf import TSDFVolume
from opencv_contrib_tpu_torch.rgbd.warpfield import WarpField
from opencv_contrib_tpu_torch.sfm.pipeline_scale import MapState

TUPLES = {cls.__name__: cls for cls in (Keypoints, Matches, BAProblem, BAResult, SparseBAProblem, SparseBAResult,
                                        ObsBuckets, TSDFVolume, DepthFrame, HashTSDF, PoseGraph, ColoredTSDFVolume,
                                        RansacResult, MapState, WarpField, Signature, EllipticKeypoints,
                                        Template)}


def wb_model(W, device="cpu") -> torch.Tensor:
    """A learning-based white-balance model of either package (the (F, 2)
    matrix of `xphoto.fit_wb_model`: a JAX array, numpy or a tensor) as
    this package's float32 tensor on `device`."""
    a = np.asarray(W.detach().cpu() if isinstance(W, torch.Tensor) else W, np.float32)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"a white-balance model is (F, 2), got {a.shape}")
    return torch.from_numpy(a.copy()).to(device)


EDGE_FOREST_KEYS = ("W1", "b1", "W2", "b2")


def edge_forest_params(params_np, device="cpu") -> dict:
    """The learned edge map's parameters of either package (a dict of JAX
    arrays, numpy or tensors under W1 (D, hidden), b1 (hidden,), W2
    (hidden, 1), b2 (1,)) as this package's dict of float32 tensors on
    `device`, for `ximgproc.edge_forest.structured_edges` or as `train`'s
    initial parameters."""
    if set(params_np) != set(EDGE_FOREST_KEYS):
        raise ValueError(f"edge forest parameters are {EDGE_FOREST_KEYS}, got {sorted(params_np)}")
    out = {}
    for k in EDGE_FOREST_KEYS:
        v = params_np[k]
        out[k] = torch.from_numpy(np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                                           np.float32)).to(device)
    D, hidden = out["W1"].shape
    if out["b1"].shape != (hidden,) or out["W2"].shape != (hidden, 1) or out["b2"].shape != (1,):
        raise ValueError(f"edge forest shapes {[tuple(out[k].shape) for k in EDGE_FOREST_KEYS]}")
    return out


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_size(x) -> bool:
    """A plain tuple of Python numbers (a shape, `Template.size`)."""
    return type(x) is tuple and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in x)


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
        return cls(*(v if _is_size(v) else from_numpy(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(np.asarray(tree)), device=device)


def to_numpy(tree):
    """The inverse of `from_numpy`: tensors -> numpy arrays, structure kept."""
    if _is_namedtuple(tree):
        return type(tree)(*(v if _is_size(v) else to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
