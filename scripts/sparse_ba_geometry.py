#!/usr/bin/env python3
"""Time the sparse BA's point sums and per-slot products (ba/sparse.py) in
the forms the port could take, side by side on one CUDA GPU, at chip_smoke
phase n's 2M-observation problem (2048 cameras, 200,000 points, 2.2 M
camera-bucket slots).

    python3 scripts/sparse_ba_geometry.py [--out build/sparse_ba_geometry.json]

Point sums (per-slot values (M, D) to per-point sums (P, D), D = 3 as in a
CG iteration and 9 as in the normal equations): the port's `_point_sums`
(one 1-D `torch.segment_reduce` a component over the point-sorted slots),
one 2-D `segment_reduce`, a padded (P, Kp) gather and sum (Kp, the most
slots of a point, read back to the host once), `index_put_(accumulate=True)`
and `index_add_` (float atomics). Each is held to a float64 sum and run 5
more times for the same bits. Per-slot products: `torch.matmul` of the
solver's 2x3 by 3x3 and 2x2 by 2x6 factors against `bundle._small_mm`, and
the (P, 3, 3) by (P, 3) product as a batched GEMV against the elementwise
form. Times are chip_smoke's profiler timing (device ms per call, 10 calls).
Prints one JSON line per case, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args()

    import torch

    from opencv_contrib_tpu_torch.ba import sparse
    from opencv_contrib_tpu_torch.ba.bundle import _small_mm
    from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

    if not torch.cuda.is_available():
        print("sparse_ba_geometry: no CUDA device", file=sys.stderr)
        return 2
    smoke = chip_smoke.Smoke()
    dev = smoke.dev
    prob, buckets = chip_smoke.two_million_problem(dev)
    sl = sparse._bucket_slots(prob, buckets)
    P = prob.points.shape[0]
    M = sl.pt.numel()
    seg = torch.where(sl.ok, sl.pt, P).reshape(-1)
    order = sl.order
    counts = order.offsets[1:P + 1] - order.offsets[:P]
    kp = int(counts.max())
    k = torch.arange(kp, device=dev)
    first = order.offsets[:P, None] + k[None, :]
    pad_idx = torch.where(k[None, :] < counts[:, None], order.perm[first.clamp(max=M - 1)], M)
    gen = torch.Generator(dev).manual_seed(0)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for D in (3, 9):
        vals = torch.randn(M, D, device=dev, generator=gen)
        ref = torch.zeros(P + 1, D, dtype=torch.float64, device=dev).index_add_(0, seg, vals.double())[:P]
        valsz = torch.cat([vals, torch.zeros(1, D, device=dev)])
        forms = {
            "point_sums (1-D segment_reduce a component)": lambda: sparse._point_sums(vals, order),
            "segment_reduce 2-D": lambda: torch.segment_reduce(vals[order.perm], "sum", offsets=order.offsets,
                                                               axis=0, unsafe=True)[:-1],
            "padded (P, Kp) gather + sum": lambda: valsz[pad_idx].sum(1),
            "index_put_ accumulate": lambda: torch.zeros(P + 1, D, device=dev).index_put_(
                (seg,), vals, accumulate=True)[:P],
            "index_add_ (atomics)": lambda: torch.zeros(P + 1, D, device=dev).index_add_(0, seg, vals)[:P],
        }
        for name, fn in forms.items():
            out = fn()
            emit({"case": "point_sums", "form": name, "D": D, "slots": M, "points": P, "kp": kp,
                  "ms": smoke.device_ms(fn, iters=10), "same_bits_5_runs": all(torch.equal(fn(), out) for _ in range(5)),
                  "max_abs_err_vs_f64": float((out.double() - ref).abs().max())})

    C, Kc = sl.pt.shape
    a23 = torch.randn(C, Kc, 2, 3, device=dev, generator=gen)
    b33 = torch.randn(C, Kc, 3, 3, device=dev, generator=gen)
    a22 = torch.randn(C, Kc, 2, 2, device=dev, generator=gen)
    b26 = torch.randn(C, Kc, 2, 6, device=dev, generator=gen)
    vinv = torch.randn(P, 3, 3, device=dev, generator=gen)
    v = torch.randn(P, 3, device=dev, generator=gen)
    with f32_matmul_precision():
        for name, fn, small in (("(C, Kc) 2x3 @ 3x3", lambda: a23 @ b33, lambda: _small_mm(a23, b33)),
                                ("(C, Kc) 2x2 @ 2x6", lambda: a22 @ b26, lambda: _small_mm(a22, b26)),
                                ("(P) 3x3 @ 3", lambda: torch.einsum("pij,pj->pi", vinv, v),
                                 lambda: torch.sum(vinv * v[:, None, :], dim=-1))):
            err = float((fn() - small()).abs().max())
            emit({"case": "per_slot_product", "shape": name, "batched_gemm_ms": smoke.device_ms(fn, iters=10),
                  "elementwise_ms": smoke.device_ms(small, iters=10), "max_abs_diff": err})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
