"""Seconds from the process's start to the window's: imports, the card,
the builds (the first run in a checkout compiles), the data made from the
seed and put on the card, and the warm-up."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
