"""Tracing — the port of opencv_contrib_tpu/utils/tracing.py.

`trace_span(name)` is the CV_TRACE_FUNCTION analog: it opens a
`torch.profiler.record_function` range, so the span shows in a profiler trace
beside the device work it enqueued (as KinFu's stage ranges do), and it
records the span's wall-clock time on the host. The host clock measures host
time only: CUDA calls return before the device has run their work, so a
span's time is its enqueue time unless something inside it waits for the
device. Device time comes from a profiler trace (`profile_to`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_SPANS: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def trace_span(name: str):
    """Time the span on the host clock and mark it in the profiler trace."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _SPANS[name].append(time.perf_counter() - t0)


def span_stats() -> dict[str, dict]:
    """Host wall-clock time of each span name since the last reset."""
    out = {}
    for name, ts in _SPANS.items():
        out[name] = {
            "count": len(ts),
            "total_s": sum(ts),
            "mean_ms": 1e3 * sum(ts) / max(len(ts), 1),
            "max_ms": 1e3 * max(ts),
        }
    return out


def reset_spans():
    _SPANS.clear()


@contextlib.contextmanager
def profile_to(logdir: str):
    """Profile the span (host ops, and the device where the profiler can
    trace it) and write a Chrome trace to `logdir`/trace.json."""
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=sorted(torch.profiler.supported_activities(), key=str)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
