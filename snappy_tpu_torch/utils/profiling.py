"""Tracing hooks: named ranges in ``torch.profiler`` traces.

Usage:
    with trace_annotation("framed.dispatch_uncompress"):
        ...
"""

from __future__ import annotations

import torch


def trace_annotation(name: str):
    """Named region in the profiler trace (CPU timeline; device work
    launched inside it is linked to it)."""
    return torch.profiler.record_function(name)
