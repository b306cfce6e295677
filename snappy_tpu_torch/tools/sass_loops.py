"""The loops of one kernel in a ``cuobjdump -sass`` dump, with the
instructions each holds and the spans within it that a forward branch skips.

    python -m snappy_tpu_torch.tools.sass_loops SASS KERNEL [--json]

SASS is the text ``cuobjdump -sass`` prints for a cubin or a shared library;
KERNEL a substring of a function's mangled name (the first function that
holds it is read). A loop is a backward branch and the instructions from its
target to it. A skip is a forward branch inside a loop and the instructions
between it and its target, which run only where the branch is not taken
(for example a block that only some warps run). Warp instructions a step of
a kernel are the loop's count less the skips a warp does not run, summed
over the block's warps; over the SM's 4 schedulers that gives the cycles a
step at one instruction a cycle each: the issue bound. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from dataclasses import asdict, dataclass, field
from pathlib import Path

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


@dataclass
class Span:
    start: int  # address of the branch (a loop: its target)
    end: int  # address of the target (a loop: the branch)
    insns: int  # instructions strictly inside (a loop: target through branch)
    skips: list = field(default_factory=list)


def instructions(sass: str, kernel: str) -> list[tuple[int, str, str]]:
    """(address, opcode, operands) of the first function whose name holds
    ``kernel``; raises if there is none."""
    out, inside = [], False
    for line in sass.splitlines():
        f = _FUNC.search(line)
        if f:
            if inside:
                break
            inside = kernel in f.group(1)
            continue
        m = _INSN.search(line) if inside else None
        if m:
            out.append((int(m.group(1), 16), m.group(3), m.group(4)))
    if not out:
        raise ValueError(f"no function holding {kernel!r} in the dump")
    return out


def loops(insns: list[tuple[int, str, str]]) -> list[Span]:
    """Each backward branch's loop, outermost first, with the forward
    branches inside it as skips."""
    index = {a: i for i, (a, _, _) in enumerate(insns)}
    spans = []
    for i, (addr, op, args) in enumerate(insns):
        t = _TARGET.search(args)
        if op.startswith("BRA") and t and int(t.group(1), 16) <= addr and int(t.group(1), 16) in index:
            j = index[int(t.group(1), 16)]
            spans.append(Span(insns[j][0], addr, i - j + 1))
    for s in spans:
        for i, (addr, op, args) in enumerate(insns):
            t = _TARGET.search(args)
            if op.startswith("BRA") and t and s.start <= addr < int(t.group(1), 16) <= s.end:
                end = int(t.group(1), 16)
                s.skips.append(Span(addr, end, index[end] - i - 1 if end in index else 0))
    return sorted(spans, key=lambda s: (s.start, -s.end))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.sass_loops")
    ap.add_argument("sass", type=Path)
    ap.add_argument("kernel")
    ap.add_argument("--json", action="store_true", help="print one JSON line")
    args = ap.parse_args(argv)
    try:
        found = loops(instructions(args.sass.read_text(), args.kernel))
    except (OSError, ValueError) as e:
        print(f"sass_loops: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({"kernel": args.kernel, "loops": [asdict(s) for s in found]}))
        return 0
    for s in found:
        print(f"loop {s.start:#06x}-{s.end:#06x}: {s.insns} instructions")
        for k in s.skips:
            print(f"  skip {k.start:#06x}-{k.end:#06x}: {k.insns} instructions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
