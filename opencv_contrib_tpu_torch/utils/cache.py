"""Where the port keeps what it builds: the twin of opencv_contrib_tpu/
utils/cache.py, the persistent XLA compilation cache helper.

The port's compiled artefacts are the hand-written kernels and host
routines that `ops/cuda/_build` compiles at first use (nvcc for
`csrc/*.cu`, the host compiler for the PNG unfilter and the JPEG codec),
keyed by a hash of their sources and flags so a later process reuses them.
`enable_compile_cache(path)` sets that directory: `path`, else the
`OCV_TPU_CACHE` environment variable, else `build/kernels` at the root of
the checkout (`_build.DEFAULT_ROOT`). With `OCV_TPU_NO_CACHE`
set, each process builds into a directory of its own under it
(`proc-<pid>`), so nothing built by another process is reused.

It never disables a kernel or routes around one: every call still runs the
kernel built from the checkout's sources. Call it before the first kernel
or host routine is built; the libraries a process has already loaded stay
loaded from where they were built.
"""

from __future__ import annotations

import os
from pathlib import Path

from opencv_contrib_tpu_torch.ops.cuda import _build


def enable_compile_cache(path: str | None = None) -> Path:
    """Set (and return) the directory the kernels and host routines are
    built into and loaded from."""
    root = Path(path or os.environ.get("OCV_TPU_CACHE") or _build.DEFAULT_ROOT)
    if os.environ.get("OCV_TPU_NO_CACHE"):
        root = root / f"proc-{os.getpid()}"
    _build.BUILD_ROOT = root
    return root
