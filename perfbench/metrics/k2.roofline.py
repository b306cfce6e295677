"""K2's share of its HBM roofline over the traced window: the least time
of the bytes the window's batches need (``roofline.encode_bytes``: the
blocks read once, the streams written once) over the device time of the
kernels named ``encode_blocks_kernel`` in the trace, in %."""

from perfbench import roofline

LAYER = "kernel K2"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "encode_gbps"
KERNEL = r"\bencode_blocks_kernel\b"


def read(run):
    if run.direction != "encode" or run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    return roofline.share(roofline.encode_bytes(run.bytes, run.rows, run.comp_bytes), seconds, run.device_kind)
