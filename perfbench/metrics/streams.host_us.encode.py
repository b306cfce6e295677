"""Host microseconds a batch spends in the program's raw-stream encoder
(``snappy_tpu_torch/parallel/distributed.py::compress_streams``: its checks,
the fragment table's torch ops, K2's and K5's wrappers and their launches,
up to the last launch's return), from the program's own span
``streams.compress``, a batch's mean over the traced window. A program
without that span gives nothing."""

from perfbench import program

LAYER = "raw-stream encode API"
UNIT = "us"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "encode_gbps"


def read(run):
    if run.direction != "encode":
        return None
    return program.mean_us(program.window_spans(run, "streams.compress"))
