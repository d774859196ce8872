"""Stage-parallel (pipeline-parallel) execution over a mesh — the port of
opencv_contrib_tpu/parallel/stage_pipeline.py.

The PP analog of SURVEY §2.2 P9: a detect -> describe -> match style stage
chain where each rank of the mesh axis OWNS one stage and items flow rank
k -> k + 1 by point-to-point sends, software pipelining on the classic
(T + S - 1)-step schedule, so S ranks overlap S different items once the
pipeline fills.

As in the JAX package, every stage maps an item of one fixed shape and
dtype to an item of the same shape and dtype. A rank runs its stage only on
the steps that hold an item for it (the JAX scan computes on padding at the
others and drops the results), and the last rank's outputs are broadcast to
every rank of the axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from opencv_contrib_tpu_torch.parallel.mesh import axis_index, axis_size, global_rank, mesh_device


def _schedule(stages, T: int, shape, dtype, mesh: DeviceMesh, axis: str, fetch) -> torch.Tensor:
    """Run T items through the chain; `fetch(t)` is called on every rank at
    every step t < T and returns item t on the rank of stage 0."""
    S = axis_size(mesh, axis)
    if len(stages) != S:
        raise ValueError(f"{len(stages)} stages on an axis of extent {S}: pad with identity_stage")
    k = axis_index(mesh, axis)
    dev = mesh_device(mesh)
    group = mesh.get_group(axis)
    outs = torch.zeros((T,) + shape, dtype=dtype, device=dev)
    sends = []
    for t in range(T + S - 1):
        x = fetch(t) if t < T else None
        i = t - k  # the item at this rank's stage on step t
        if not 0 <= i < T:
            continue
        if k > 0:
            x = torch.empty(shape, dtype=dtype, device=dev)
            dist.recv(x, global_rank(mesh, axis, k - 1), group=group)
        y = stages[k](x)
        if y.shape != shape or y.dtype != dtype:
            raise ValueError(f"stage {k} maps {tuple(shape)} {dtype} to {tuple(y.shape)} {y.dtype}")
        if k < S - 1:  # hand off to the next stage's rank
            sends.append(dist.isend(y.contiguous(), global_rank(mesh, axis, k + 1), group=group))
        else:
            outs[i] = y
    for w in sends:
        w.wait()
    dist.broadcast(outs, global_rank(mesh, axis, S - 1), group=group)  # replicate the last rank's rows
    return outs


def pipeline_map(stages, items, mesh: DeviceMesh, axis: str = "pp") -> torch.Tensor:
    """Run `items` (T, ...) through the stage chain with rank k of `axis`
    running stages[k]. Returns (T, ...) fully processed items on every rank.

    len(stages) must equal the mesh extent along `axis`. Wall-clock is
    (T + S - 1) pipeline steps instead of T * S sequential stage calls.
    """
    items = torch.as_tensor(items).to(mesh_device(mesh))
    first = axis_index(mesh, axis) == 0
    return _schedule(stages, items.shape[0], tuple(items.shape[1:]), items.dtype, mesh, axis,
                     lambda t: items[t] if first else None)


def pipeline_map_sharded(stages, items, mesh: DeviceMesh, axis: str = "pp") -> torch.Tensor:
    """pipeline_map with the feed SHARDED over the pipeline axis instead of
    replicated: rank d keeps the items t with t % S == d (O(T / S) feed
    memory a rank), and stage 0 receives item t from its owner at step t.
    Same (T + S - 1)-step schedule and outputs."""
    items = torch.as_tensor(items)
    S, k = axis_size(mesh, axis), axis_index(mesh, axis)
    mine = items[k::S].to(mesh_device(mesh))  # this rank's round-robin feed slice
    group = mesh.get_group(axis)
    sends = []

    def fetch(t):
        owner = t % S
        if owner == k:
            if k == 0:
                return mine[t // S]
            sends.append(dist.isend(mine[t // S].contiguous(), global_rank(mesh, axis, 0), group=group))
        elif k == 0:
            x = torch.empty(mine.shape[1:], dtype=mine.dtype, device=mine.device)
            dist.recv(x, global_rank(mesh, axis, owner), group=group)
            return x
        return None

    out = _schedule(stages, items.shape[0], tuple(items.shape[1:]), items.dtype, mesh, axis, fetch)
    for w in sends:
        w.wait()
    return out


# ---------------------------------------------------------------------------
# the real workload: detect -> describe -> match as pipeline stages


def frontend_stages(ref_desc: torch.Tensor, ref_valid: torch.Tensor, img_hw=(64, 64), n_kp: int = 16,
                    threshold: float = 1e-4):
    """The feature-frontend chain (SURF-class detect -> describe ->
    ratio-test match against a reference frame) as pipeline stages over a
    flat f32 carrier buffer. Returns (stages, pack_image, unpack_matches,
    carrier_len); pad `stages` with `identity_stage` to the mesh extent.

    Carrier layout: [image HW | keypoints 6K (y, x, scale, angle, resp,
    valid) | descriptors K*D | matches 2K (train_idx, distance)].
    """
    from opencv_contrib_tpu_torch.features import describe as fdesc
    from opencv_contrib_tpu_torch.features import detect as fdet
    from opencv_contrib_tpu_torch.features import match as fmatch
    from opencv_contrib_tpu_torch.features.keypoints import Keypoints

    H, W = img_hw
    D = int(ref_desc.shape[1])
    o_img, o_kp = 0, H * W
    o_desc = o_kp + 6 * n_kp
    o_match = o_desc + n_kp * D
    C = o_match + 2 * n_kp

    def put(buf, flat, at):
        out = buf.clone()
        out[at:at + flat.numel()] = flat
        return out

    def stage_detect(buf):
        img = buf[o_img:o_img + H * W].reshape(H, W)
        kp = fdet.fast_hessian(img, max_keypoints=n_kp, threshold=threshold)
        return put(buf, torch.cat([kp.y, kp.x, kp.scale, kp.angle, kp.response, kp.valid.to(torch.float32)]), o_kp)

    def stage_describe(buf):
        img = buf[o_img:o_img + H * W].reshape(H, W)
        f = buf[o_kp:o_kp + 6 * n_kp].reshape(6, n_kp)
        kp = Keypoints(y=f[0], x=f[1], scale=f[2], angle=f[3], response=f[4], valid=f[5] > 0.5)
        return put(buf, fdesc.surf_describe(img, kp).reshape(-1), o_desc)

    def stage_match(buf):
        desc = buf[o_desc:o_desc + n_kp * D].reshape(n_kp, D)
        valid = buf[o_kp + 5 * n_kp:o_kp + 6 * n_kp] > 0.5
        m = fmatch.ratio_test_match(desc, ref_desc.to(buf.device), q_valid=valid, t_valid=ref_valid.to(buf.device),
                                    ratio=0.9)
        dist_ = torch.where(torch.isfinite(m.distance), m.distance, torch.full_like(m.distance, -1.0))
        return put(buf, torch.cat([m.train_idx.to(torch.float32), dist_]), o_match)

    def pack_image(img):
        img = torch.as_tensor(img, dtype=torch.float32)
        buf = torch.zeros(C, dtype=torch.float32, device=img.device)
        buf[:H * W] = img.reshape(-1)
        return buf

    def unpack_matches(buf):
        m = buf[o_match:o_match + 2 * n_kp]
        return m[:n_kp].to(torch.int32), m[n_kp:]

    return [stage_detect, stage_describe, stage_match], pack_image, unpack_matches, C


def identity_stage(buf):
    return buf
