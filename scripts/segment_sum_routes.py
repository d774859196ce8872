#!/usr/bin/env python3
"""Time the two routes that a segment sum could take on one CUDA GPU, on
the inputs that `entry.ximgproc_frame`'s methods give it, and the methods
themselves with each route.

    python3 scripts/segment_sum_routes.py [--out build/segment_sum_routes.json]

The routes: `onehot`, a product of the (N, n) one-hot matrix in the
values' dtype, built from a comparison as the port's, with the (N, D)
values (cuBLAS, full float32 precision), and `index_put`,
`index_put_(accumulate=True)`, which sorts the ids and adds each segment's
run in order; `port_route` says which one `ops.segment.segment_sum` takes. Every method of `entry.METHODS` runs once on
`entry.structure_frame()` (VGA; graph segmentation and selective search at
240 x 320, as chip_smoke.py's phase u) with the port's `segment_sum`
recording its inputs: the first call of each method and shape is kept.
For each kept input and route: device ms per call (CUDA events around 20
calls, the median of 5 such groups, the routes in turns A B B A), the peak
memory above what was held, whether a rerun gives the same bits, and
whether the sum holds the bits of the CPU's `index_add_` (the port's CPU
route, the JAX version's order). Then each method that sums by segment
runs with each route in the port's place: ms per warm synchronised call,
the median of 5, in turns A B B A. It prints one JSON line per input and
per method, the card's name and power limit, and writes everything to
--out.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CUT = {"graph_segment": (240, 320), "selective_search": (240, 320)}  # chip_smoke.py's XIMG_CUT


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "segment_sum_routes.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from opencv_contrib_tpu_torch import entry
    from opencv_contrib_tpu_torch.ops import segment as oseg
    from opencv_contrib_tpu_torch.utils.precision import f32_matmul_precision

    if not torch.cuda.is_available():
        raise SystemExit("segment_sum_routes: no CUDA device")
    dev = torch.device("cuda")
    # by module path: the package `ximgproc` exports a function `slic` that hides its module
    users = [importlib.import_module(f"opencv_contrib_tpu_torch.{m}") for m in (
        "ximgproc.slic", "ximgproc.superpixels_x", "ximgproc.transforms_x", "ximgproc.edline",
        "ximgproc.segmentation", "hfs.segment")]
    port_sum = oseg.segment_sum

    def prep(ids, values, n):
        ids = ids.reshape(-1).long()
        dt = torch.float64 if values.dtype == torch.float64 else torch.float32
        return ids, values.reshape(ids.shape[0], -1).to(dt), dt

    def onehot(ids, values, n):
        ids, v, dt = prep(ids, values, n)
        one_hot = (ids[:, None] == torch.arange(n, device=ids.device)).to(dt)
        with f32_matmul_precision():
            out = one_hot.T @ v
        return out.reshape((n,) + tuple(values.shape[1:]))

    def index_put(ids, values, n):
        ids, v, dt = prep(ids, values, n)
        out = torch.zeros((n, v.shape[1]), dtype=dt, device=ids.device)
        out.index_put_((ids,), v, accumulate=True)
        return out.reshape((n,) + tuple(values.shape[1:]))

    def cpu_sum(ids, values, n):
        ids, v, dt = prep(ids.cpu(), values.cpu(), n)
        out = torch.zeros((n, v.shape[1]), dtype=dt)
        out.index_add_(0, ids, v)
        return out.reshape((n,) + tuple(values.shape[1:]))

    routes = {"onehot": onehot, "index_put": index_put}

    def use(fn):
        for mod in users:
            mod.segment_sum = fn

    frames = {s: entry.structure_frame(*s) for s in {(480, 640), *CUT.values()}}
    on_card = {s: (torch.from_numpy(f.rgb).to(dev), torch.from_numpy(f.disparity).to(dev)) for s, f in frames.items()}

    def call(m):
        rgb, disp = on_card[CUT.get(m, (480, 640))]
        return entry.ximgproc_frame(rgb, m, device=dev, disparity=disp)

    kept, users_of = {}, {}
    for m in entry.METHODS:
        seen = []

        def record(ids, values, n, m=m, seen=seen):
            seen.append(1)
            key = (m, tuple(ids.shape), tuple(values.shape), str(values.dtype), int(n))
            kept.setdefault(key, (ids.detach().clone(), values.detach().clone(), int(n)))
            return port_sum(ids, values, n)

        use(record)
        call(m)
        torch.cuda.synchronize()
        if seen:
            users_of[m] = len(seen)
    use(port_sum)

    def device_ms(fn, reps=20, groups=5):
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(groups):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            per.append(a.elapsed_time(b) / reps)
        return statistics.median(per)

    def peak_gb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    inputs = []
    for (m, ishape, vshape, dtype, n), (ids, values, n) in kept.items():
        ref = cpu_sum(ids, values, n)
        row = {"method": m, "ids": list(ishape), "values": list(vshape), "dtype": dtype, "n": n,
               "port_route": "onehot" if n <= oseg.ONE_HOT_MAX else "index_put", "routes": {}}
        for name, fn in routes.items():
            a, b = fn(ids, values, n), fn(ids, values, n)
            row["routes"][name] = {"rerun_bit_equal": bool(torch.equal(a, b)),
                                   "cpu_bit_equal": bool(torch.equal(a.cpu(), ref)),
                                   "max_abs_vs_cpu": float((a.cpu() - ref).abs().max()) if ref.numel() else 0.0,
                                   "peak_gb": peak_gb(lambda: fn(ids, values, n)), "ms": []}
        for name in ("onehot", "index_put", "index_put", "onehot"):
            row["routes"][name]["ms"].append(device_ms(lambda: routes[name](ids, values, n)))
        inputs.append(row)
        print(json.dumps(row), flush=True)

    def wall_ms(m, groups=5):
        call(m)
        torch.cuda.synchronize()
        per = []
        for _ in range(groups):
            t = time.perf_counter()
            call(m)
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t) * 1e3)
        return statistics.median(per)

    methods = []
    for m, n_calls in users_of.items():
        row = {"method": m, "segment_sums_a_call": n_calls, "ms": {k: [] for k in routes}}
        for name in ("onehot", "index_put", "index_put", "onehot"):
            use(routes[name])
            row["ms"][name].append(wall_ms(m))
        use(port_sum)
        methods.append(row)
        print(json.dumps(row), flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": smi, "torch": torch.__version__, "inputs": inputs,
                                          "methods": methods}, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
