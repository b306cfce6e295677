"""Faults a block codec can have, planted in a result to see the check
catch them (``tests/test_perfbench_faults.py`` on the CPU, ``control.py
--fault`` at a cell's size).

A result is what an entry's ``call`` returns: (out, ok, total) for a
decode, (out, olens) for an encode; the first tensor holds one row a block.

- ``unchanged``: every call returns the first call's result, as a step
  that leaves its state as it found it;
- ``half``: the second half of the batch is left out, its rows zero;
- ``altered``: one byte of every row is changed where it is produced.

A cell on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half", "altered")


def plant(fault: str, fn):
    """``fn`` (a call returning a result as above) with ``fault`` planted."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")
    first = []

    def broken(*args, **kwargs):
        result = fn(*args, **kwargs)
        if fault == "unchanged":
            if not first:
                first.append(tuple(t.clone() for t in result))
            return first[0]
        out, *rest = (t.clone() for t in result)
        rows = torch.arange(out.shape[0], device=out.device)
        if fault == "half":
            out[out.shape[0] // 2 :] = 0
            if len(rest) == 1:  # an encode's lengths
                rest[0][out.shape[0] // 2 :] = 0
        else:
            col = (rest[0].long() - 1).clamp(min=0) if len(rest) == 1 else torch.zeros_like(rows)
            out[rows, col] ^= 0x55
        return (out, *rest)

    return broken
