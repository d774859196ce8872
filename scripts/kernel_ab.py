#!/usr/bin/env python3
"""Time two checkouts' knn2, integral_image, integral() and grid_scan in one
run on one CUDA GPU, in turns: base, this, this, base.

    python3 scripts/kernel_ab.py --base DIR [--out build/kernel_ab.json]

DIR is the root of another checkout of the repository (for instance a
`git archive` of the parent commit unpacked under build/). Each turn is a
process of its own that imports the port from its checkout (which builds
that checkout's kernels into its own build/kernels/) and times each kernel
at the shapes of this checkout's chip_smoke.py phases b and c, with its
Timer: device time per call from torch.profiler over 30 calls, L2-warm and
L2-cold (a 128 MiB read before each call), and device launches per call.
Inputs are made from one seed, so both checkouts see the same data. It
prints one JSON line per turn, the card's name and power limit, and writes
every turn to --out.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import opencv_contrib_tpu_torch as port
    from opencv_contrib_tpu_torch.ops import integral
    from opencv_contrib_tpu_torch.ops.cuda import _build, matching, scan

    assert Path(port.__file__).resolve().is_relative_to(root.resolve()), port.__file__
    spec = importlib.util.spec_from_file_location("chip_smoke_timer", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    timer = smoke.Timer(torch, dev)
    _build.build()
    gen = np.random.default_rng(0)
    card = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)  # noqa: E731

    def row(name, shape, fn):
        return {"kernel": name, "shape": list(shape), "ms": timer.device_ms(fn, iters=30),
                "cold_ms": timer.device_ms(fn, iters=30, cold=True), "launches_per_call": timer.launches_per_call(fn)}

    rows = []
    for Q, T, D in smoke.KNN2_SHAPES:
        q, t = card(gen.normal(size=(Q, D))), card(gen.normal(size=(T, D)))
        rows.append(row("knn2", (Q, T, D), lambda: matching.knn2(q, t)))
    for H, W in smoke.SCAN_SHAPES:
        x = card(gen.uniform(0, 255, size=(H, W)))
        rows.append(row("integral_image", (H, W), lambda: scan.integral_image(x)))
        rows.append(row("integral", (H, W), lambda: integral.integral(x)))
    for H, W in smoke.GRID_SCAN_SHAPES:
        x = card(gen.uniform(0, 255, size=(H, W)))
        rows.append(row("grid_scan", (H, W), lambda: scan.grid_scan(x)))
    return {"root": str(root), "device": torch.cuda.get_device_name(0), "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, help="root of the checkout to compare with")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_ab.json")
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    import torch

    if args.base is None:
        ap.error("--base is required")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    turns = []
    for label, root in (("base", args.base), ("this", ROOT), ("this", ROOT), ("base", args.base)):
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(root.resolve())],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stdout, p.stderr, file=sys.stderr)
            return p.returncode
        turn = {"label": label, **json.loads(p.stdout.strip().splitlines()[-1])}
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
