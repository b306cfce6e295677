"""The share of K4's slices whose chart the join met, over this run's
process: the program's counter ``streams.slices_met`` (slices the join
entered at a position their chart's chain holds, or never entered) over
``streams.slices`` (slices charted), in %. A slice the join does not meet
is walked tag by tag, so the share says how much of a long stream's serial
chain the charts took off it. A program without these counters, or that
charted no slice, gives nothing."""

from perfbench import program

LAYER = "kernel K4"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "decode_gbps"


def read(run):
    if run.direction != "decode":
        return None
    slices, met = program.counter("streams.slices"), program.counter("streams.slices_met")
    return None if not slices or met is None else 100 * met / slices
