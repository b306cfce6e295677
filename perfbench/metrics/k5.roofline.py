"""K5's share of its HBM roofline over the traced window: the least time
of the bytes the window's batches move (``roofline_k5.join_bytes``: the
fragments' streams read once with their lengths, the packed streams and
their starts and lengths written once) over the device time of the kernels
named ``join_streams_kernel`` in the trace, in %. The window's fragments
are its pages times the program's fragments a page (its counters
``streams.enc_fragments`` over ``streams.enc_streams``); a program without
K5 or those counters gives nothing."""

from perfbench import program, roofline_k5

LAYER = "kernel K5"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "encode_gbps"
KERNEL = r"\bjoin_streams_kernel\b"


def read(run):
    if run.direction != "encode" or run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNEL)
    streams, fragments = program.counter("streams.enc_streams"), program.counter("streams.enc_fragments")
    if seconds <= 0 or not streams or fragments is None:
        return None
    frags = round(run.rows * fragments / streams)
    return roofline_k5.share(roofline_k5.join_bytes(run.comp_bytes, run.rows, frags), seconds, run.device_kind)
