"""Uncompressed bytes of every batch decoded in the window, over the
window's whole time on the host's clock, in GB/s."""

UNIT = "GB/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    if run.direction != "decode" or run.window_s <= 0:
        return None
    return run.bytes / run.window_s / 1e9
