"""The rows K4 cut a raw stream into, on average over this run's process:
the program's counter ``streams.segments`` (the rows that hold a segment or
a whole stream) over ``streams.streams`` (streams decoded). About one a
64 KiB of page for libsnappy-parse pages; 1 where every stream is taken
whole. A program without these counters gives nothing."""

from perfbench import program

LAYER = "kernel K4"
UNIT = "segments/stream"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "decode_gbps"


def read(run):
    if run.direction != "decode":
        return None
    streams, segments = program.counter("streams.streams"), program.counter("streams.segments")
    return None if not streams or segments is None else segments / streams
