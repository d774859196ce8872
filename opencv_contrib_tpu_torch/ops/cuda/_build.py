"""Build and load the hand-written Hopper kernels under `csrc/`.

Each `csrc/*.cu` file has a plain C interface. At first use every source is
compiled by its own `nvcc` process (all started together) into a shared
library for `sm_90a`, in `build/kernels/<hash>/` at the root of the checkout,
keyed on a hash of the sources and the flags, and loaded with `ctypes`. A
later call, or a later process on the same checkout, reuses the libraries.

Every C entry point returns `cudaGetLastError()` after its launches;
`check()` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point, by library (source stem)
SIGNATURES = {
    "scan": {
        # x, y, H, W, stream
        "scan_rows_f32": [_P, _P, _I, _I, _P],
        "scan_cols_f32": [_P, _P, _I, _I, _P],
    },
    "knn2": {
        # q, t, Q, T, D, span, tn, part_best, part_second, part_idx,
        # dist, idx, stream
        "knn2_f32": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    },
    "reduce_vec": {
        # T, intr, src_pts, src_nrm, src_valid, dst_pts, dst_nrm, dst_valid,
        # n, Hd, Wd, dist2, cos_thresh, blocks, partials, out, stream
        "icp_getab_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _P],
    },
    "pyrdown": {
        # x, out, H, W, border, stream
        "pyrdown_f32": [_P, _P, _I, _I, _I, _P],
    },
    "remap": {
        # maps, dy, dx, out, C, H, W, bounded, max_disp, ylim, xlim, stream
        "remap_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by
    name. Thread-safe; compiles each source at most once per checkout."""
    with _lock:
        if _libs:
            return _libs
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        procs = []
        for src in sources:
            lib = out_dir / f"lib{src.stem}.so"
            if lib.exists():
                continue
            tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, lib, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        libs = {}
        for src in sources:
            lib = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
            for fn, argtypes in SIGNATURES[src.stem].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            libs[src.stem] = lib
        _libs.update(libs)
        return _libs


def lib(name: str) -> ctypes.CDLL:
    return build()[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
