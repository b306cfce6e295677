"""The rows an SM held at once in K2's launches, on average over this run's
process: the program's counter ``k2.sm_rows`` (each launched row weighted
by the blocks an SM of the kernel variant that ran it holds) over
``k2.rows`` (rows launched). 2 where every row took the 32 KiB variant, 1
where every row took the 64 KiB one. A program without these counters
gives nothing."""

from perfbench import program

LAYER = "kernel K2"
UNIT = "rows"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "encode_gbps"


def read(run):
    if run.direction != "encode":
        return None
    rows, sm_rows = program.counter("k2.rows"), program.counter("k2.sm_rows")
    return None if not rows or sm_rows is None else sm_rows / rows
