"""The program's tracing: spans and counters at its layer boundaries, and
``torch.profiler`` traces.

The counterpart of ``snappy_tpu/utils/profiling.py``.

Spans. ``trace_annotation(name)`` opens a span named ``<layer>.<stage>``.
It records only while a ``torch.profiler`` session records (torch's own
flag) or while an operator holds ``recording()`` open. Otherwise entering
it reads that flag and returns a shared null context: no allocation, no
clock reading, no ``record_function``. A recorded span keeps its name, its
start and end on ``time.time_ns()`` (the clock a profiler's Chrome trace
stamps its events on, ``ts`` microseconds after its
``baseTimeNanoseconds``), its thread, its parent (the innermost span open on
that thread when it opened) and its request (the outermost one). Under the
profiler it also opens ``record_function(name)``, so the exported trace
holds it beside the card's kernels. The newest ``MAX_SPANS`` are kept in
memory as plain tuples, which the garbage collector stops tracking, so a
full buffer adds no collector pauses; older ones are dropped and counted
under ``trace.spans_dropped``. ``spans(name)`` returns them as
``SpanRecord`` and ``self_ns`` gives a span's self time.

Counters. ``count(name, n)`` adds to one registry of integers and seconds,
always on. ``counters()`` returns a copy; readers take differences of
copies (``since``).

Usage:
    with trace_annotation("framed.dispatch_uncompress"):
        ...
    with recording():                # spans without a profiler
        ...
    before = counters(); ...; since(before)["k1.launches"]
    with profile_to("/tmp/trace"):   # a Chrome trace (chrome://tracing, Perfetto)
        ...
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import socket
import threading
import time

import torch
import torch.autograd.profiler as _profiler  # its _is_profiler_enabled is torch's flag

# Spans kept in memory: a 10 s window of 2 ms batches opens ~15,000.
MAX_SPANS = 1 << 17

_lock = threading.Lock()  # guards _counts, _recording and the drop count
_counts: dict[str, float] = {}
_recording = 0  # recording() blocks open
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)  # SpanRecord fields, as tuples
_ids = itertools.count(1)
_NULL = contextlib.nullcontext()


class _Thread(threading.local):
    def __init__(self):
        self.stack: list[Span] = []  # the spans open on this thread, innermost last


_thread = _Thread()


#: A span kept: times in ``time.time_ns()`` nanoseconds; ``child_ns`` is
#: the part of it that its children cover.
SpanRecord = collections.namedtuple("SpanRecord", "name id parent request thread start_ns end_ns child_ns")


class Span:
    """An open span, with ``SpanRecord``'s fields once it has closed."""

    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns", "end_ns", "child_ns", "_up", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _thread.stack
        self._up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = self._up.id if self._up is not None else None
        self.request = stack[0].id if stack else self.id
        self.thread = threading.get_ident()
        self.child_ns = 0
        stack.append(self)
        self._rf = None
        self.start_ns = time.time_ns()
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.time_ns()
        _thread.stack.remove(self)  # the last, unless a generator closed spans out of order
        if self._up is not None:
            self._up.child_ns += self.end_ns - self.start_ns
            self._up = None
        with _lock:
            if len(_spans) == _spans.maxlen:
                _counts["trace.spans_dropped"] = _counts.get("trace.spans_dropped", 0) + 1
            _spans.append((self.name, self.id, self.parent, self.request, self.thread, self.start_ns, self.end_ns,
                           self.child_ns))
        return False


def trace_annotation(name: str):
    """A span named ``name`` (``<layer>.<stage>``): recorded, and a named
    range in the profiler's trace, while tracing is on; a shared null
    context otherwise."""
    if _profiler._is_profiler_enabled or _recording:
        return Span(name)
    return _NULL


@contextlib.contextmanager
def recording():
    """Record spans while the block is open, with no profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans(name: str | None = None) -> list[SpanRecord]:
    """The spans kept, in the order they closed; only those named ``name``
    where it is given."""
    with _lock:
        kept = list(_spans)
    return [SpanRecord._make(s) for s in kept if name is None or s[0] == name]


def self_ns(span) -> int:
    """``span``'s self time: its duration less the part of it that its
    children on its thread cover."""
    return span.end_ns - span.start_ns - span.child_ns


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, float]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def since(before: dict[str, float]) -> collections.Counter:
    """Each counter's change since the copy ``before``; 0 for a counter
    that has not moved."""
    now = counters()
    return collections.Counter({k: v - before.get(k, 0) for k, v in now.items()})


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a profiler trace of the enclosed region into ``logdir`` (made
    if missing), one Chrome-trace JSON file a region, written also when the
    region raises: the host's ops and spans, and the card's kernels and
    copies where CUDA is available."""
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
