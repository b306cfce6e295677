"""Milliseconds the program's kernel loader spent in its slow path in this
run's process, up to the time of reading (the program's counter
``kernels.load_s``): finding nvcc (the ``torch.utils.cpp_extension``
import), hashing the sources, nvcc where a library is built, and the
dlopen. A part of ``setup_s``; a run that builds K1 or K2 reads the nvcc
seconds more."""

from perfbench import program

LAYER = "kernel loader"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(run):
    seconds = program.counter("kernels.load_s")
    return None if seconds is None else 1000 * seconds
