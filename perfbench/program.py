"""What the program records of itself, for the readers of per-layer metrics:
its spans and counters (``snappy_tpu_torch.utils.profiling``). A span
records while a ``torch.profiler`` session records, so a traced window's
spans are the program's newest. A program without that registry gives
nothing, and a reader of it reports nothing."""

from __future__ import annotations


def registry():
    """The program's span and counter registry, or None where it has none."""
    try:
        from snappy_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if all(hasattr(profiling, f) for f in ("spans", "self_ns", "counters")) else None


def window_spans(run, name: str):
    """The program's spans named ``name`` of the traced window's batches,
    one a batch: the last ``run.batches`` it recorded. None for a run that
    was not traced, or where the program recorded fewer."""
    reg = registry()
    if reg is None or run.trace is None or run.batches < 1:
        return None
    got = reg.spans(name)
    return got[-run.batches:] if len(got) >= run.batches else None


def mean_us(spans, self_time: bool = False) -> float | None:
    """The mean duration of ``spans`` in microseconds, or of their self
    times (each less the part its children cover); None for no spans."""
    if spans is None:
        return None
    reg = registry()
    ns = [reg.self_ns(s) if self_time else s.end_ns - s.start_ns for s in spans]
    return sum(ns) / len(ns) / 1e3


def counter(name: str):
    """The program's counter ``name`` at the time of reading, or None where
    it has no such counter."""
    reg = registry()
    return None if reg is None else reg.counters().get(name)
