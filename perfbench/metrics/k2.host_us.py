"""Host microseconds an encode batch spends in K2's wrapper
(``snappy_tpu_torch/ops/cuda_encode.py::encode_blocks``: its checks, its
two allocations and the launch), from the program's own span
``k2.encode_blocks``, a batch's mean over the traced window."""

from perfbench import program

LAYER = "K2 wrapper"
UNIT = "us"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "encode_gbps"


def read(run):
    if run.direction != "encode":
        return None
    return program.mean_us(program.window_spans(run, "k2.encode_blocks"))
