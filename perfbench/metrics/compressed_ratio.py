"""The streams' lengths over the uncompressed bytes, summed over every
batch encoded in the window: bytes stored a byte of input."""

UNIT = "bytes/byte"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    if run.direction != "encode" or run.bytes <= 0:
        return None
    return run.comp_bytes / run.bytes
