"""Host microseconds a decode batch spends in K1's wrapper
(``snappy_tpu_torch/ops/cuda_decode.py::decode_blocks``: its checks, its
three allocations and the launch), from the program's own span
``k1.decode_blocks``, a batch's mean over the traced window."""

from perfbench import program

LAYER = "K1 wrapper"
UNIT = "us"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "decode_gbps"


def read(run):
    if run.direction != "decode":
        return None
    return program.mean_us(program.window_spans(run, "k1.decode_blocks"))
