"""Checkpoint / resume of (distributed) SLAM / SfM state — the port of
opencv_contrib_tpu/parallel/checkpoint.py.

Parity role: the reference's persistence layer — cv::Algorithm read/write
FileStorage + the hdf module's bulk-array store (hdf5.hpp:56-198, SURVEY
§5.4) — extended with what the reference lacks: multi-process
checkpoint-restart. The file is the JAX package's npz layout: the leaves in
`jax.tree_util` order as `leaf_{i}` and the structure's text as a `treedef`
byte blob, so a file either package writes (without orbax) restores in the
other. Dicts flatten by sorted key, as `jax.tree_util` does (not in
insertion order, as `torch.utils._pytree` does); lists, tuples and
NamedTuples in order; None holds no leaf. Orbax, the JAX package's
production path, has no PyTorch counterpart here: `use_orbax=True` raises.
Under a process group of more than one rank, rank 0 writes and every rank
meets at a barrier.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list) -> str:
    """Append the leaves of `tree` in jax.tree_util order; return the text
    of its structure as JAX's PyTreeDef prints it."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        kids = ", ".join(_flatten(x, leaves) for x in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{kids}])"
    if isinstance(tree, (list, tuple)):
        kids = [_flatten(x, leaves) for x in tree]
        if isinstance(tree, list):
            return "[" + ", ".join(kids) + "]"
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
    leaves.append(tree)
    return "*"


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken in order from the iterator
    `leaves`; a tensor leaf of `like` gives a tensor on its device and of its
    dtype, any other a numpy array."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    x = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(x)).to(device=like.device, dtype=like.dtype)
    return x


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _many_ranks() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _no_orbax(use_orbax) -> None:
    if use_orbax:
        raise NotImplementedError("orbax checkpoints need the JAX package; the port writes the npz layout "
                                  "(use_orbax=False)")


def save_pytree(path: str, tree, use_orbax: bool | None = None) -> str:
    """Checkpoint any pytree of tensors and arrays (leaves gathered to the
    host) to `path` + ".npz"; returns the file's path."""
    _no_orbax(use_orbax)
    path = os.path.abspath(path)
    path = path if path.endswith(".npz") else path + ".npz"
    if not _many_ranks() or dist.get_rank() == 0:
        leaves = []
        text = f"PyTreeDef({_flatten(tree, leaves)})"
        np.savez(path, treedef=np.frombuffer(text.encode(), dtype=np.uint8),
                 **{f"leaf_{i}": _host(x) for i, x in enumerate(leaves)})
    if _many_ranks():
        dist.barrier()
    return path


def restore_pytree(path: str, like, use_orbax: bool | None = None):
    """Restore a checkpoint into the structure of `like`."""
    _no_orbax(use_orbax)
    path = os.path.abspath(path)
    slots = []
    _flatten(like, slots)
    with np.load(path if path.endswith(".npz") else path + ".npz") as f:
        return _unflatten(like, iter([f[f"leaf_{i}"] for i in range(len(slots))]))


def save_slam_state(path: str, volume=None, T_cw=None, posegraph=None, extra=None) -> str:
    """Convenience wrapper for the SLAM loop's resumable state (the 'tracks,
    camera params, landmark blocks, volume units, optimizer state'
    checkpoint of SURVEY §5.4)."""
    tree = {}
    if volume is not None:
        tree["volume"] = volume
    if T_cw is not None:
        tree["T_cw"] = T_cw
    if posegraph is not None:
        tree["posegraph"] = posegraph
    if extra:
        tree.update(extra)
    return save_pytree(path, tree)
