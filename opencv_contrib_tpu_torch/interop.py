"""Carry state between the JAX package and this one as numpy arrays.

The port's learned state is the trained BRISQUE head, the learning-based
white balance's regressor, the learned edge map's MLP, the Siamese
tracker's backbone, and the detection and face models: WaldBoost's
(`xobjdetect.waldboost.WaldBoostModel`), the DPM
(`dpm.DPMModel`), the recognizers' subspace (`face.recognizers.SubspaceModel`),
the AAM (`face.aam.AAMModel`) and Facemark's cascade
(`face.facemark.FacemarkModel`), NamedTuples that cross by `from_numpy`. The head, `quality.brisque_svr.BrisqueModel`,
holds host numpy arrays in both packages and its npz (`save_model`,
`load_model`) is the same file: it crosses as it is. The regressor,
`xphoto.fit_wb_model`'s (F, 2) matrix, crosses by `wb_model`. The edge
map's MLP, `ximgproc.edge_forest.train`'s {"W1", "b1", "W2", "b2"}, crosses
by `edge_forest_params`. A trained point-pair-feature model
(`surface_matching.PPFModel`) crosses by `ppf_model`; the Siamese
tracker's backbone (`tracking.siam.SiamBackbone`, flax's parameters in the
twin) by `siam_params`; a multi-index over binary line codes
(`line_descriptor.MIHIndex`, uint32 codes in the twin) by
`mih_index_from_jax`; motion saliency's model (`saliency.MotionSaliency`)
by `motion_saliency_from_jax`; the omnidir and
registration parameters are plain arrays and need no converter.

The rest of the port's state is the NamedTuples (Keypoints,
Matches, BAProblem, BAResult, the sparse BA's SparseBAProblem,
SparseBAResult and ObsBuckets, KinFu's TSDFVolume and DepthFrame, the
hashed-block volume's HashTSDF, the pose graph's PoseGraph, the colored
volume's ColoredTSDFVolume (which nests a TSDFVolume), the RANSAC's
RansacResult, the 5k-view driver's device-resident MapState, DynaFu's
WarpField, PCT's Signature, TBMR's EllipticKeypoints, LINEMOD's Template,
the background subtractors' MogState, CntState, GmgState, GsocState and
LsbpState, the retina's RetinaState and TransientState), with the same class names, field names and field order in both
packages. `from_numpy` turns such a tuple, its fields read as
numpy arrays (anything `np.asarray` takes), into this package's tuple of
tensors; `to_numpy` goes the other way. A field of such a tuple that holds a
Python tuple of numbers, as `Template.size` does, or a bare Python number,
as `WaldBoostModel.win` and `DPMModel.bias` do, crosses as it is. GSOC's
`key` does not cross: the twin's is a PRNG key, the port's a
`torch.Generator`, so `from_numpy` of a GsocState needs `key=` (the
generator to put there).

The host-side SfM state, `sfm.tracks.TracksTensor`,"""

from __future__ import annotations

import numpy as np
import torch

from opencv_contrib_tpu_torch.ba.bundle import BAProblem, BAResult
from opencv_contrib_tpu_torch.bgsegm import CntState, GmgState, GsocState, LsbpState, MogState
from opencv_contrib_tpu_torch.bioinspired import RetinaState, TransientState
from opencv_contrib_tpu_torch.dpm import DPMModel
from opencv_contrib_tpu_torch.face.aam import AAMModel
from opencv_contrib_tpu_torch.face.facemark import FacemarkModel
from opencv_contrib_tpu_torch.face.recognizers import SubspaceModel
from opencv_contrib_tpu_torch.ba.sparse import ObsBuckets, SparseBAProblem, SparseBAResult
from opencv_contrib_tpu_torch.features.detect_x import EllipticKeypoints
from opencv_contrib_tpu_torch.features.keypoints import Keypoints
from opencv_contrib_tpu_torch.features.match import Matches
from opencv_contrib_tpu_torch.features.pct import Signature
from opencv_contrib_tpu_torch.line_descriptor.mih import MIHIndex
from opencv_contrib_tpu_torch.mvg.robust import RansacResult
from opencv_contrib_tpu_torch.rgbd.colored_tsdf import ColoredTSDFVolume
from opencv_contrib_tpu_torch.rgbd.frame import DepthFrame
from opencv_contrib_tpu_torch.rgbd.hash_tsdf import HashTSDF
from opencv_contrib_tpu_torch.rgbd.linemod import Template
from opencv_contrib_tpu_torch.rgbd.posegraph import PoseGraph
from opencv_contrib_tpu_torch.rgbd.tsdf import TSDFVolume
from opencv_contrib_tpu_torch.rgbd.warpfield import WarpField
from opencv_contrib_tpu_torch.saliency.motion import MotionSaliency
from opencv_contrib_tpu_torch.sfm.pipeline_scale import MapState
from opencv_contrib_tpu_torch.surface_matching.ppf import PPFModel
from opencv_contrib_tpu_torch.xobjdetect.waldboost import WaldBoostModel

TUPLES = {cls.__name__: cls for cls in (Keypoints, Matches, BAProblem, BAResult, SparseBAProblem, SparseBAResult,
                                        ObsBuckets, TSDFVolume, DepthFrame, HashTSDF, PoseGraph, ColoredTSDFVolume,
                                        RansacResult, MapState, WarpField, Signature, EllipticKeypoints,
                                        Template, MogState, CntState, GmgState, GsocState, LsbpState, RetinaState,
                                        TransientState, WaldBoostModel, DPMModel, SubspaceModel, AAMModel,
                                        FacemarkModel)}


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


def ppf_model(model_np, device="cpu") -> PPFModel:
    """A trained point-pair-feature model of either package
    (`surface_matching.train_model`'s PPFModel: its fields as JAX arrays,
    numpy, Python numbers or tensors) as this package's PPFModel on
    `device`: points, normals and alpha float32, keys and ref_idx int32,
    dist_step, angle_step and diameter 0-dim float32 (the twin keeps
    angle_step a Python float; its float32 rounding is the one the twin's
    quantizer divides by)."""
    if tuple(getattr(model_np, "_fields", ())) != PPFModel._fields:
        raise TypeError(f"a PPF model has the fields {PPFModel._fields}, got {type(model_np).__name__}")

    def arr(v, dtype):
        a = np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v, dtype)
        return torch.from_numpy(a).to(device)

    m = model_np
    return PPFModel(points=arr(m.points, np.float32), normals=arr(m.normals, np.float32),
                    keys=arr(m.keys, np.int32), ref_idx=arr(m.ref_idx, np.int32), alpha=arr(m.alpha, np.float32),
                    dist_step=arr(m.dist_step, np.float32), angle_step=arr(m.angle_step, np.float32),
                    diameter=arr(m.diameter, np.float32))


SIAM_LAYERS = (("Conv_0", "conv1"), ("Conv_1", "conv2"), ("Conv_2", "conv3"))


def siam_params(params_np, device="cpu") -> dict:
    """The Siamese backbone's parameters of the JAX package (flax's
    {"Conv_0": {"kernel": (3, 3, I, O) HWIO, "bias": (O,)}, "Conv_1",
    "Conv_2"}, as JAX or numpy arrays) as the state dict of this package's
    `tracking.siam.SiamBackbone` on `device`: kernels OIHW, float32."""
    if set(params_np) != {f for f, _ in SIAM_LAYERS}:
        raise ValueError(f"Siamese backbone parameters are {[f for f, _ in SIAM_LAYERS]}, got {sorted(params_np)}")
    out = {}
    for flax_name, torch_name in SIAM_LAYERS:
        kernel = np.asarray(params_np[flax_name]["kernel"], np.float32)
        bias = np.asarray(params_np[flax_name]["bias"], np.float32)
        if kernel.ndim != 4 or bias.shape != (kernel.shape[3],):
            raise ValueError(f"{flax_name}: kernel {kernel.shape}, bias {bias.shape}")
        out[f"{torch_name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))).to(device)
        out[f"{torch_name}.bias"] = torch.from_numpy(bias.copy()).to(device)
    return out


def mih_index_from_jax(index, device="cpu") -> MIHIndex:
    """A multi-index of the JAX package (`line_descriptor.mih_build`'s
    MIHIndex: buckets (m, 2^b, cap) int32, codes (N, n_words) uint32, b) as
    this package's MIHIndex on `device`: the buckets as they are, the codes
    as int32 words of the same bits (the port's packed-code type)."""
    if tuple(getattr(index, "_fields", ())) != MIHIndex._fields:
        raise TypeError(f"an MIH index has the fields {MIHIndex._fields}, got {type(index).__name__}")
    codes = np.asarray(index.codes)
    if codes.dtype not in (np.uint32, np.int32):
        raise TypeError(f"MIH codes are 32-bit words, got {codes.dtype}")
    return MIHIndex(buckets=torch.from_numpy(np.array(index.buckets, np.int32)).to(device),
                    codes=torch.from_numpy(codes.view(np.int32).copy()).to(device), b=int(index.b))


def motion_saliency_from_jax(state, device="cpu") -> MotionSaliency:
    """Motion saliency's model of the JAX package (`saliency.motion_create` /
    `motion_apply`'s MotionSaliency: mean, var, a scalar frame count) as this
    package's on `device`: float32, the count a 0-d tensor."""
    if tuple(getattr(state, "_fields", ())) != MotionSaliency._fields:
        raise TypeError(f"a motion model has the fields {MotionSaliency._fields}, got {type(state).__name__}")
    return MotionSaliency(*(torch.from_numpy(np.array(v, np.float32)).to(device) for v in state))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _is_size(x) -> bool:
    """A bare Python number (`WaldBoostModel.win`, `DPMModel.bias`) or a
    plain tuple of them (a shape, `Template.size`)."""
    return type(x) in (int, float) or (type(x) is tuple and all(_is_number(v) for v in x))


def from_numpy(tree, device="cpu", key=None):
    """NamedTuple / tuple / list / dict of arrays -> the same structure of
    tensors on `device`; a NamedTuple maps to this package's class of the
    same name. A GsocState (or an LsbpState holding one) takes `key`, the
    torch.Generator its draws come from, in place of the twin's PRNG key."""
    if _is_namedtuple(tree):
        cls = TUPLES.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no counterpart for {type(tree).__name__}")
        if cls._fields != tree._fields:
            raise TypeError(f"{cls.__name__}: fields {tree._fields} != {cls._fields}")
        if cls is GsocState:
            if not isinstance(key, torch.Generator):
                raise TypeError("a GsocState's key is a torch.Generator: pass key=")
            return GsocState(from_numpy(tree.samples, device), from_numpy(tree.hits, device), key)
        return cls(*(v if _is_size(v) else from_numpy(v, device, key) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device, key) for v in tree)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, key) for k, v in tree.items()}
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
    if isinstance(tree, torch.Generator):
        return tree
    return np.asarray(tree)
