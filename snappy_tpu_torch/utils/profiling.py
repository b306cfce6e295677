"""Tracing hooks: named ranges in ``torch.profiler`` traces.

The counterpart of ``snappy_tpu/utils/profiling.py``.

Usage:
    with trace_annotation("framed.dispatch_uncompress"):
        ...
    with profile_to("/tmp/trace"):   # a Chrome trace (chrome://tracing, Perfetto)
        ...
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


def trace_annotation(name: str):
    """Named region in the profiler trace (CPU timeline; device work
    launched inside it is linked to it)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a profiler trace of the enclosed region into ``logdir`` (made
    if missing), one Chrome-trace JSON file a region, written also when the
    region raises: the host's ops and annotations, and the card's kernels
    and copies where CUDA is available."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(logdir, name))
