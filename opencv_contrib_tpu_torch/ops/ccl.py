"""Connected-component labelling by min-label flooding with pointer jumping,
and per-component statistics (the port of opencv_contrib_tpu/ops/ccl.py).

Each pass takes the minimum label over the 4- or 8-neighbourhood and then
follows the label chain one hop. The JAX version loops in a `while_loop`
until a pass moves no label, or `max_iters` passes, and returns the pass
count. Here the passes run in groups of `PASSES_A_READ` under `torch.where`,
which freezes the labels once the loop would have stopped, and the host reads
the stop flag once a group: one host sync a group, not one a pass. The count
is the JAX version's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BIG = torch.iinfo(torch.int32).max
PASSES_A_READ = 8
# dump slots of component_stats: the background and the components past
# max_components spread over this many, so that no slot collects most pixels
# (the card's deterministic accumulating scatter walks a slot's run serially)
DUMP_SLOTS = 1024

_SHIFTS4 = [(0, 1), (0, -1), (1, 0), (-1, 0)]
_SHIFTS8 = _SHIFTS4 + [(1, 1), (1, -1), (-1, 1), (-1, -1)]


def _min_neighbor_pass(labels: torch.Tensor, mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    """The neighbourhood minimum of (..., H, W) labels; leading axes are
    masks labelled alike."""
    H, W = labels.shape[-2:]
    L = torch.where(mask, labels, BIG)
    p = F.pad(L, (1, 1, 1, 1), value=BIG)
    out = L
    for dy, dx in _SHIFTS8 if connectivity == 8 else _SHIFTS4:
        out = torch.minimum(out, p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return torch.where(mask, out, BIG)


def _pass(labels: torch.Tensor, mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    """One flood pass and one pointer jump; each (H, W) image's labels are
    raster indices within it."""
    new = _min_neighbor_pass(labels, mask, connectivity).flatten(-2)
    big = new == BIG
    safe = torch.where(big, 0, new).long()
    return torch.where(big, BIG, torch.minimum(new, torch.gather(new, -1, safe))).reshape(labels.shape)


def connected_components(mask: torch.Tensor, connectivity: int = 4, max_iters: int = 64):
    """Label the True pixels of mask (H, W). Returns (labels, n_passes):
    labels int32, -1 on the background, each component carrying the least
    raster index of its pixels; n_passes a 0-d int32 tensor. A stack
    (..., H, W) is labelled in one batch, each mask as alone (its passes
    frozen where its own loop would stop; the twin's vmap), with n_passes
    of the leading shape."""
    mask = mask.to(torch.bool)
    H, W = mask.shape[-2:]
    idx = torch.arange(H * W, dtype=torch.int32, device=mask.device).reshape(H, W)
    labels = torch.where(mask, idx, BIG)
    n = torch.zeros(mask.shape[:-2], dtype=torch.int32, device=mask.device)
    active = torch.ones(mask.shape[:-2], dtype=torch.bool, device=mask.device)
    done = 0
    while done < max_iters:
        for _ in range(min(PASSES_A_READ, max_iters - done)):
            new = _pass(labels, mask, connectivity)
            moved = (new != labels).flatten(-2).any(-1)
            labels = torch.where(active[..., None, None], new, labels)
            n = n + active.to(torch.int32)
            active = active & moved & (n < max_iters)
            done += 1
        if not bool(active.any()):
            break
    return torch.where(mask, labels, -1), n


def component_stats(labels: torch.Tensor, values: torch.Tensor | None = None, max_components: int = 256) -> dict:
    """Per-component statistics in arrays of a fixed size: the raw
    raster-index labels are ranked into [0, max_components) in raster order
    of their roots, and components past that share an overflow slot that is
    dropped. Returns a dict of (max_components,) tensors: area, y0, x0, y1,
    x1, valid, with sum and sumsq of `values` when given, and cid_map (H, W),
    -1 on the background. The dropped pixels scatter into DUMP_SLOTS slots
    past the kept ones."""
    H, W = labels.shape
    dev = labels.device
    flat = labels.reshape(-1)
    is_fg = flat >= 0
    idx = torch.arange(H * W, dtype=torch.int32, device=dev)
    is_root = is_fg & (flat == idx)
    rank = torch.cumsum(is_root.to(torch.int32), 0).to(torch.int32) - 1
    comp_of_root = torch.where(is_root, rank, 0)
    safe = torch.where(is_fg, flat, 0).long()
    cid = torch.clamp(torch.where(is_fg, comp_of_root[safe], max_components), max=max_components).long()
    slot = torch.where(cid < max_components, cid, max_components + torch.remainder(idx, DUMP_SLOTS).long())

    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W).reshape(-1)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W).reshape(-1)
    inf = torch.full((), float("inf"), device=dev)
    C = max_components + DUMP_SLOTS

    def add(v):
        return torch.zeros(C, device=dev).index_put_((slot,), v, accumulate=True)[:max_components]

    def reduce(v, fill, how):
        return torch.full((C,), fill, device=dev).scatter_reduce_(0, slot, v, how)[:max_components]

    area = add(is_fg.to(torch.float32))
    out = {"area": area,
           "y0": reduce(torch.where(is_fg, yy, inf), float("inf"), "amin"),
           "x0": reduce(torch.where(is_fg, xx, inf), float("inf"), "amin"),
           "y1": reduce(torch.where(is_fg, yy, -inf), -float("inf"), "amax"),
           "x1": reduce(torch.where(is_fg, xx, -inf), -float("inf"), "amax"),
           "valid": area > 0}
    if values is not None:
        v = values.reshape(-1).to(torch.float32)
        out["sum"] = add(torch.where(is_fg, v, 0.0))
        out["sumsq"] = add(torch.where(is_fg, v * v, 0.0))
    out["cid_map"] = torch.where(is_fg, cid.to(torch.int32), -1).reshape(H, W)
    return out
