"""Host microseconds a batch spends in the program's raw-stream API
(``snappy_tpu_torch/parallel/distributed.py::decompress_streams``: its
checks, K4's and K1's wrappers and their launches, up to the last launch's
return), from the program's own span ``streams.decompress``, a batch's mean
over the traced window."""

from perfbench import program

LAYER = "raw-stream API"
UNIT = "us"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decode_gbps"


def read(run):
    if run.direction != "decode":
        return None
    return program.mean_us(program.window_spans(run, "streams.decompress"))
