"""Metrics and profiling utilities."""

from .metrics import Metrics, time_device_fn
from .profiling import profile_to, trace_annotation

__all__ = ["Metrics", "profile_to", "time_device_fn", "trace_annotation"]
