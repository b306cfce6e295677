"""K1's share of its HBM roofline over the traced window: the least time
of the bytes the window's batches need (``roofline.decode_bytes``: the
streams read once, the blocks written once) over the device time of the
kernels named ``decode_blocks_kernel`` in the trace, in %."""

from perfbench import roofline

LAYER = "kernel K1"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "decode_gbps"
KERNEL = r"\bdecode_blocks_kernel\b"


def read(run):
    if run.direction != "decode" or run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    return roofline.share(roofline.decode_bytes(run.comp_bytes, run.rows, run.bytes), seconds, run.device_kind)
