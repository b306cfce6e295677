"""Typed error hierarchy for the codec.

The reference collapses every failure into a bare ``ErrorException``
(reference src/Snappy.jl:21,50; src/internal.jl:499,505,518; src/varint.jl:36).
We keep the same *trigger conditions* but expose typed exceptions so callers
can distinguish corrupt input from misuse.
"""


class SnappyError(Exception):
    """Base class for all snappy_tpu_torch errors."""


class CorruptInputError(SnappyError):
    """The compressed stream is malformed (bad varint, offset, or length)."""


class InputTooLargeError(SnappyError):
    """Input exceeds the 2**32-1 byte limit of the format header."""
