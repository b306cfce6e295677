"""What a ``torch.profiler`` trace of the window says: the card's busy
time, each kernel's time, and what the host was doing while the card idled.

The union arithmetic is that of the program's
``tools/profile_stream.py::busy_share`` when this copy was taken: device
events (kernels, copies, fills) sorted by start, each adding what it covers
beyond the ones before it.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "perfbench."
WINDOW_SPAN = "perfbench.window"
TOP = 10


def union(intervals) -> list[tuple[float, float]]:
    """The merged (start, end) runs that ``intervals`` cover."""
    runs: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if runs and lo <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], hi)
        else:
            runs.append([lo, hi])
    return [(lo, hi) for lo, hi in runs]


@dataclass
class Trace:
    """The window of one traced run; times in microseconds of the trace's
    clock, durations reported in seconds."""

    start: float
    end: float
    device: list[tuple[str, float, float]]  # (name, start, end), clipped to the window
    spans: list[tuple[str, float, float]]  # the benchmark's own host spans
    busy: list[tuple[float, float]] = field(default_factory=list)

    def __post_init__(self):
        self.busy = union((lo, hi) for _, lo, hi in self.device)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        """Seconds of the device events whose name ``pattern`` matches."""
        rx = re.compile(pattern)
        return sum(hi - lo for name, lo, hi in self.device if rx.search(name)) / 1e6

    def device_ops(self) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        by_name: dict[str, float] = defaultdict(float)
        for name, lo, hi in self.device:
            by_name[name] += (hi - lo) / 1e6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    def gaps(self) -> list[tuple[float, float]]:
        """The window's stretches in which the card ran nothing."""
        out, at = [], self.start
        for lo, hi in self.busy:
            if lo > at:
                out.append((at, lo))
            at = max(at, hi)
        if self.end > at:
            out.append((at, self.end))
        return out

    def idle_gaps(self) -> list[list]:
        """Idle seconds by the innermost benchmark span open on the host
        when each gap began: [span, seconds], the longest first."""
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        by_span: dict[str, float] = defaultdict(float)
        for lo, hi in self.gaps():
            # The spans inside the window do not nest, so the latest to
            # start before the gap is the only one that can hold it; a gap
            # in none of them is the window loop's own.
            i = bisect.bisect_right(starts, lo) - 1
            name = spans[i][0] if i >= 0 and spans[i][2] > lo else WINDOW_SPAN
            by_span[name] += (hi - lo) / 1e6
        return [[n, s] for n, s in sorted(by_span.items(), key=lambda kv: -kv[1])[:TOP]]


def read(path: Path) -> Trace | None:
    """The window of a Chrome trace that ``torch.profiler`` exported, or
    None where it holds no window span."""
    events = [e for e in json.loads(Path(path).read_text()).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    w = windows[0]
    start, end = float(w["ts"]), float(w["ts"]) + float(w.get("dur", 0))
    device, spans = [], []
    for e in events:
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if e.get("cat") in DEVICE_CATS:
            lo, hi = max(lo, start), min(hi, end)
            if hi > lo:
                device.append((e["name"], lo, hi))
        elif e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX) and e["name"] != WINDOW_SPAN:
            spans.append((e["name"], lo, hi))
    return Trace(start, end, device, spans)
