"""``tools/drain_parts.py`` on the CPU: each build it makes names switches
that the probes' source defines, and without a card it refuses."""

import pytest

from snappy_tpu_torch.ops.kernels import CSRC
from snappy_tpu_torch.tools import drain_parts


@pytest.mark.parametrize("name", sorted(drain_parts.CUTS))
def test_cuts_are_switches_of_the_source(name):
    source = (CSRC / "exp_vector_walk.cu").read_text()
    for define in drain_parts.CUTS[name]:
        macro, value = define.split("=")
        assert f"#ifndef {macro}\n#define {macro} 1\n#endif" in source and value == "0"
        assert source.count(f"({macro} && ") + source.count(f"if ({macro})") >= 1


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(drain_parts.torch.cuda, "is_available", lambda: False)
    assert drain_parts.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
