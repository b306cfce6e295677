"""``tools/sass_loops.py`` on a dump written here: a kernel's loops, the
instructions each holds, and the spans a forward branch skips."""

import json

import pytest

from snappy_tpu_torch.tools import sass_loops

_DUMP = """
        code for sm_90a
                Function : _Z5otherPi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   BRA 0x0 ;
                Function : _Z6drain8ILi0EEvPi
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000e220000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   DEPBAR.LE SB0, 0x4 ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/               @P0 BRA 0x70 ;
        /*0050*/                   LDS.64 R2, [R4] ;
        /*0060*/              @!P1 STG.E desc[UR4][R2.64], R5 ;
        /*0070*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0080*/               @P2 BRA 0x20 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
"""


def _loops(tmp_path, kernel="drain8"):
    p = tmp_path / "k.sass"
    p.write_text(_DUMP)
    return sass_loops.loops(sass_loops.instructions(p.read_text(), kernel))


def test_loops_and_skips(tmp_path):
    """The loop from 0x20 to its branch at 0x80 holds 7 instructions; the
    branch at 0x40 skips the 2 before 0x70. The self-branch after EXIT is a
    loop of one; the other function is not read."""
    main, tail = _loops(tmp_path)
    assert (main.start, main.end, main.insns) == (0x20, 0x80, 7)
    assert [(s.start, s.end, s.insns) for s in main.skips] == [(0x40, 0x70, 2)]
    assert (tail.start, tail.end, tail.insns, tail.skips) == (0xA0, 0xA0, 1, [])


def test_cli(tmp_path, capsys):
    p = tmp_path / "k.sass"
    p.write_text(_DUMP)
    assert sass_loops.main([str(p), "drain8", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["loops"][0]["insns"] == 7 and rec["loops"][0]["skips"][0]["insns"] == 2
    assert sass_loops.main([str(p), "drain8"]) == 0
    assert "loop 0x0020-0x0080: 7 instructions" in capsys.readouterr().out
    assert sass_loops.main([str(p), "nothing"]) == 2
    with pytest.raises(ValueError):
        sass_loops.instructions(_DUMP, "nothing")
