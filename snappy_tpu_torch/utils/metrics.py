"""Structured per-run metrics, and device timing of one call.

The counterpart of ``snappy_tpu/utils/metrics.py``: ``Metrics`` collects
throughput, ratio and timing records and writes them as JSON;
``time_device_fn`` times a function on the device its tensor arguments live
on, and ``device_times`` gives each of its samples.
"""

from __future__ import annotations

import json
import statistics
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Metrics:
    run: dict = field(default_factory=dict)
    results: list = field(default_factory=list)

    def add(self, **kv) -> None:
        self.results.append(kv)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"run": self.run, "results": self.results, "ts": time.time()}, f, indent=2)


def device_times(fn, args, iters: int = 10, warmup: int = 3) -> list[float]:
    """Seconds of each of ``iters`` timed calls ``fn(*args)``, after
    ``warmup`` untimed ones.

    The device is that of the first tensor in ``args``. On a CUDA device each
    call is timed with CUDA events on the current stream (device time from
    the first kernel's start to the last one's end, not the host's enqueue);
    on the CPU, where calls are synchronous, with the host clock.
    """
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    if dev is None:
        raise ValueError("time_device_fn needs a tensor argument to know the device")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    for _ in range(warmup):
        fn(*args)
    times = []
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return times


def time_device_fn(fn, args, iters: int = 10, warmup: int = 3) -> float:
    """Median seconds of one call ``fn(*args)`` over ``iters`` timed calls,
    after ``warmup`` untimed ones, as ``device_times`` takes them."""
    return statistics.median(device_times(fn, args, iters, warmup))
