"""Build and load the hand-written Hopper kernels under `csrc/`.

Each `csrc/*.cu` file has a plain C interface (`csrc/*.cuh` are headers
they include). At first use every source is
compiled by its own `nvcc` process (all started together) into a shared
library for `sm_90a`, in `build/kernels/<hash>/` at the root of the checkout,
keyed on a hash of the sources and the flags, and loaded with `ctypes`. A
later call, or a later process on the same checkout, reuses the libraries.

`build_host(source, signatures)` does the same for a C++ source of the
port's host code (the PNG unfilter of `utils/png.py`), with the host
compiler, into a directory of its own beside the kernels'.

Every C entry point returns `cudaGetLastError()` after its launches;
`check()` raises when that is not 0. The argtypes of each entry point are
set once, when its library is loaded; `on_device()` enters a device guard
only when the tensor's device is not the current one.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point, by library (source stem)
SIGNATURES = {
    "scan": {
        # x, y, H, W, warps a block, run, stream
        "scan_rows_f32": [_P, _P, _I, _I, _I, _I, _P],
        # x, out, H, W, pitch, pad, slab rows, slab columns, ctrl, base, epoch,
        # column totals, row totals, stream
        "integral_f32": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P],
    },
    "knn2": {
        # q, t, Q, T, D, large, span, tickets, partials, dist, idx, stream
        "knn2_f32": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    },
    "reduce_vec": {
        # T, intr, src_pts, src_nrm, src_valid, dst_pts, dst_nrm, dst_valid,
        # n, Hd, Wd, dist2, cos_thresh, blocks, scratch, out, stream
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
    "transform": {
        # map, n_in, views (host), hparams (host), dparams, H, W, vec4, stream
        "grid_transform_f32": [_I, _I, _P, _P, _P, _I, _I, _I, _P],
        # map, hparams (host), dparams, x, y, n, blocks, stream
        "streamed_transform_f32": [_I, _P, _P, _P, _P, _I, _I, _P],
    },
    "reduce": {
        # map, kind, n_in, views (host), hparams (host), dparams, H, W, div,
        # vec4, scratch, out, stream
        "grid_reduce_f32": [_I, _I, _I, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P],
        # group, n_in, views (host), hparams (host), H, W, div (host), vec4,
        # scratch, out, stream
        "grid_reduce_sums_f32": [_I, _I, _P, _P, _I, _I, _P, _I, _P, _P, _P],
    },
    "histogram": {
        # x, rule, vec4, pitch, rows, cols, tiles_y, tiles_x, bins, vmin,
        # vmax, q, inv_q, blocks_per_tile, chunk, spread, tickets, counts,
        # out, stream
        "grid_histogram_f32": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P, _P],
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


_host_libs: dict[str, ctypes.CDLL] = {}


def _host_compiler() -> str:
    for cand in ("c++", "g++", "clang++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (c++, g++ or clang++) found: the port's host routines are built with one")


def build_host(source: Path, signatures: dict) -> ctypes.CDLL:
    """Compile (if needed) and load one C++ source of host code with the
    host compiler, into `build/kernels/host-<hash>/`; `signatures` gives the
    argtypes of each entry point, which returns an int. A failed build
    raises. Thread-safe; compiles at most once per checkout and source."""
    source = Path(source)
    with _lock:
        if source.stem in _host_libs:
            return _host_libs[source.stem]
        h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
        h.update(source.name.encode())
        h.update(source.read_bytes())
        out_dir = BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / f"lib{source.stem}.so"
        if not lib.exists():
            tmp = out_dir / f".lib{source.stem}.{os.getpid()}.{threading.get_ident()}.so"
            p = subprocess.run([_host_compiler(), *HOST_FLAGS, "-o", str(tmp), str(source)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if p.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"host build of {source.name} failed:\n{p.stdout}")
            os.replace(tmp, lib)
        dll = ctypes.CDLL(str(lib))
        for fn, argtypes in signatures.items():
            f = getattr(dll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _host_libs[source.stem] = dll
        return dll


def lib(name: str) -> ctypes.CDLL:
    return build()[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


_sms: dict = {}


def sm_count(dev) -> int:
    """The SM count of a CUDA device, read once: the launch plans size
    their grids from it."""
    n = _sms.get(dev)
    if n is None:
        import torch

        n = _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def stream_of(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def on_device(dev):
    """A context that makes `dev` the current CUDA device: none when it
    already is (entering `torch.cuda.device` costs host time on every
    launch)."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
