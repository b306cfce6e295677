"""Host microseconds a batch spends in the decode entry (the block API, its
device choice and the kernel's wrapper, up to the launch's return), from
the benchmark's own clock around each call in the traced window."""

LAYER = "block API and wrappers"
UNIT = "us"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "decode_gbps"


def read(run):
    if run.direction != "decode" or run.trace is None or not run.entry_s:
        return None
    return 1e6 * sum(run.entry_s) / len(run.entry_s)
