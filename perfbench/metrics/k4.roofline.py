"""K4's share of its HBM roofline over the traced window: the least time
of the bytes the window's batches move (``roofline_k4.segment_bytes``: the
streams read once with their arguments, every byte, the segment table
written once)
over the device time of the kernels named ``segment_streams_kernel`` in
the trace, in %. The window's segments are its pages times the program's
segments a stream (its counters ``streams.segments`` over
``streams.streams``); a program without K4 or those counters gives
nothing."""

from perfbench import program, roofline_k4

LAYER = "kernel K4"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "decode_gbps"
KERNEL = r"\bsegment_streams_kernel\b"


def read(run):
    if run.direction != "decode" or run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNEL)
    streams, segments = program.counter("streams.streams"), program.counter("streams.segments")
    if seconds <= 0 or not streams or segments is None:
        return None
    rows = round(run.rows * segments / streams)
    return roofline_k4.share(roofline_k4.segment_bytes(run.comp_bytes, run.rows, rows), seconds, run.device_kind)
