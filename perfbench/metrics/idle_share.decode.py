"""The share of the traced window in which the card ran no kernel, copy or
fill: one minus the union of the device events over the window, in %."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "decode_gbps"


def read(run):
    if run.direction != "decode" or run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
