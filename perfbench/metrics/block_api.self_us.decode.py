"""Host microseconds a decode batch spends in the block API itself
(``snappy_tpu_torch/parallel/distributed.py::decompress_blocks``: the mesh's
split, the shards' views and the decoder's choice), less what its children
take (K1's wrapper): the self time of the program's span
``blocks.decompress``, a batch's mean over the traced window."""

from perfbench import program

LAYER = "block API"
UNIT = "us"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "decode_gbps"


def read(run):
    if run.direction != "decode":
        return None
    return program.mean_us(program.window_spans(run, "blocks.decompress"), self_time=True)
