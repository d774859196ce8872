"""Meshes and collectives — the port of opencv_contrib_tpu/parallel/mesh.py
onto torch.distributed.

Canonical axes, as in the JAX package:
- "dp": data parallel — frames, views, image batches.
- "sp": spatial / structure parallel — tracks, points, map blocks, pixels.

Programming model: SPMD over processes, one rank a device. Every rank calls
a function of the layer with the same global inputs and gets the same global
outputs, the contract the JAX signatures promise. A rank computes what it
owns from its coordinates in the mesh: the ranks reshaped to (n_dp, n_sp),
so rank r sits at (r // n_sp, r % n_sp), as `init_device_mesh` places it.
Where GSPMD or `shard_map` place collectives in the JAX package, the port
calls them on the mesh's dimension groups (`mesh.get_group("sp")`): a
`psum` is an `all_reduce`, a final gather an `all_gather_into_tensor`, a
`ppermute` a `batch_isend_irecv` of `P2POp`s. An `all_reduce` gives every
rank the same bits, so decisions taken on reduced values (an LM step's
accept) agree across ranks.

The backend follows the device: NCCL for "cuda", gloo for "cpu". A mesh on
"cuda" without a card raises, and nothing falls back to gloo or to the CPU.
NCCL takes one card a rank, so a host runs at most as many ranks as it has
cards.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from opencv_contrib_tpu_torch.utils.device import resolve

AXES = ("dp", "sp")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# all_gather_into_tensor under the name newer releases give it
_all_gather_single = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _bind_card() -> None:
    """Pin this rank to its card: NCCL refuses two ranks on one GPU."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_cards = torch.cuda.device_count()
    if local > n_cards:
        raise ValueError(f"{local} ranks on this host, which has {n_cards} CUDA card(s): NCCL runs one rank a card")
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank() % n_cards)))


def make_mesh(n_dp: int | None = None, n_sp: int | None = None, devices: Sequence[int] | None = None,
              device="cuda") -> DeviceMesh:
    """Build a ("dp", "sp") mesh over the ranks `devices` (every rank of the
    process group by default), with the JAX package's defaults: n_dp = 1
    under 4 ranks, else 2, and n_sp the rest. Every rank of the group calls
    it. With no process group, a world-size-1 group is started on an
    in-process store, so one process gets a mesh as JAX gives one without
    `jax.distributed`."""
    dev = resolve(device)
    backend = BACKENDS[dev.type]
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_backend() != backend:
        raise ValueError(f"a mesh on {dev.type} runs on {backend}; the process group runs {dist.get_backend()}")
    if dev.type == "cuda":
        _bind_card()
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    n = len(ranks)
    if n_dp is None and n_sp is None:
        n_dp = 1 if n < 4 else 2  # favour sp: tracks and points usually dominate
        n_sp = n // n_dp
    elif n_dp is None:
        n_dp = n // n_sp
    elif n_sp is None:
        n_sp = n // n_dp
    if n_dp * n_sp > n or n_dp * n_sp == 0:
        raise ValueError(f"a {n_dp} x {n_sp} mesh needs {n_dp * n_sp} ranks; the process group has {n}"
                         + (" (one process a card)" if dev.type == "cuda" else ""))
    return DeviceMesh(dev.type, torch.tensor(ranks[:n_dp * n_sp]).reshape(n_dp, n_sp), mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis` (`jax.lax.axis_index`)."""
    return int(mesh.get_local_rank(axis))


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def psum(x: torch.Tensor, mesh: DeviceMesh, axes) -> torch.Tensor:
    """Sum of x over the ranks of the mesh axis or axes (`jax.lax.psum`),
    one `all_reduce` an axis; it runs on an axis of extent 1 too (NCCL's is
    then a copy). Returns the sum; a contiguous x is reduced in place."""
    x = x.contiguous()
    for a in _names(axes):
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The ranks' x concatenated along dim 0 in axis order (the gather of a
    P(axis) sharded array), on every rank of the axis."""
    x = x.contiguous()
    out = x.new_empty((axis_size(mesh, axis) * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x, group=mesh.get_group(axis))
    return out


def check_replicated(mesh: DeviceMesh, digest: int, what: str) -> None:
    """Raise unless every rank of the mesh holds the same `digest` (one
    all-gather of it an axis: equal along every axis is equal over the
    mesh)."""
    x = torch.tensor([digest], dtype=torch.int64, device=mesh_device(mesh))
    for a in mesh.mesh_dim_names:
        got = all_gather(x, mesh, a).tolist()
        if len(set(got)) > 1:
            raise RuntimeError(f"the ranks' {what} differ along {a}: digests {got}")


def global_rank(mesh: DeviceMesh, axis: str, index: int) -> int:
    """The process-group rank at coordinate `index` along `axis`, this
    rank's coordinates elsewhere."""
    return dist.get_global_rank(mesh.get_group(axis), index)


def ppermute_start(x: torch.Tensor, mesh: DeviceMesh, axis: str, shift: int = 1):
    """Start the ring permutation k -> k + shift along `axis`
    (`jax.lax.ppermute` with perm [(k, (k + shift) % n)]): returns the
    buffer that receives the block of rank k - shift and a function that
    waits for it. On an axis of extent 1 the permutation is the identity
    and nothing is sent: the buffer is x itself."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x, lambda: x
    me = axis_index(mesh, axis)
    group = mesh.get_group(axis)
    x = x.contiguous()
    buf = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, global_rank(mesh, axis, (me + shift) % n), group),
        dist.P2POp(dist.irecv, buf, global_rank(mesh, axis, (me - shift) % n), group)])

    def wait():
        for r in reqs:
            r.wait()
        return buf

    return buf, wait


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str, shift: int = 1) -> torch.Tensor:
    return ppermute_start(x, mesh, axis, shift)[1]()


def check_divisible(size: int, mesh: DeviceMesh, axes, what: str) -> int:
    """size / (the product of the axes' extents); raises where a JAX
    NamedSharding would refuse the shape (no silent padding)."""
    n = int(np.prod([axis_size(mesh, a) for a in _names(axes)]))
    if size % n:
        raise ValueError(f"{what} ({size}) must divide by the mesh's {'x'.join(_names(axes))} extent {n}")
    return size // n


def _placements(mesh: DeviceMesh, spec) -> list:
    from torch.distributed.tensor import Replicate, Shard

    spec = tuple(spec)
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, s in enumerate(spec) if s == name or (isinstance(s, tuple) and name in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def shard(mesh: DeviceMesh, x, spec):
    """x as a DTensor laid out by a PartitionSpec-like tuple: a dimension
    named by a mesh axis is sharded over it (`Shard(i)`), the other axes
    replicate it. A sharded dimension must divide by its axes' extent."""
    from torch.distributed.tensor import distribute_tensor

    x = torch.as_tensor(x).to(mesh_device(mesh))
    for i, s in enumerate(tuple(spec)):
        if s is not None:
            check_divisible(x.shape[i], mesh, s, f"dimension {i}")
    return distribute_tensor(x, mesh, _placements(mesh, spec))


def replicate(mesh: DeviceMesh, x):
    return shard(mesh, x, ())


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, device="cuda") -> bool:
    """Start the process group of a multi-process run over `tcp://coordinator`
    (host:port); a no-op that returns False for a single process, as in the
    JAX package. Call it once a process, before `make_mesh`."""
    if num_processes is None or num_processes <= 1:
        return False
    dev = resolve(device)
    dist.init_process_group(BACKENDS[dev.type], init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)
    return True
