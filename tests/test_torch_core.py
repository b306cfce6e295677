"""snappy_tpu_torch.core against snappy_tpu.core: LUTs, bounds, varint,
configs; and the port's import boundary (no jax, no snappy_tpu)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import snappy_tpu.core as ref
import snappy_tpu_torch.core as port

from torch_helpers import config_from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["CHAR_TABLE", "WORDMASK"])
def test_luts_identical(name):
    a, b = getattr(ref, name), getattr(port, name)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize(
    "name",
    ["BLOCK_SIZE", "INPUT_MARGIN_BYTES", "MAX_HASH_TABLE_SIZE", "MAX_VARINT32_BYTES", "HASH_MULTIPLIER"],
)
def test_constants_identical(name):
    assert getattr(ref, name) == getattr(port, name)


@pytest.mark.parametrize("n", [0, 1, 5, 6, 59, 60, 65535, 65536, 1 << 20, 0xFFFFFFFF])
def test_max_compressed_length(n):
    assert port.max_compressed_length(n) == ref.max_compressed_length(n)


@pytest.mark.parametrize("value", [0, 1, 127, 128, 300, 16383, 16384, 1 << 21, (1 << 28) - 1, 1 << 28, 0xFFFFFFFF])
def test_varint_roundtrip_identical(value):
    enc = port.encode32(value)
    assert enc == ref.encode32(value)
    assert port.encoded_length(value) == ref.encoded_length(value) == len(enc)
    assert port.parse32(enc + b"xyz", 0) == ref.parse32(enc + b"xyz", 0) == (value, len(enc))


@pytest.mark.parametrize(
    "buf",
    [b"", b"\x80", b"\x80\x80\x80\x80\x80\x0a", b"\xff\xff\xff\xff\x10", b"\xfb\xff\xff\xff\x7f"],
)
def test_varint_corrupt_raises_in_both(buf):
    with pytest.raises(ref.CorruptInputError):
        ref.parse32(buf, 0)
    with pytest.raises(port.CorruptInputError):
        port.parse32(buf, 0)


def test_varint_out_of_range_encode():
    for bad in (-1, 1 << 32):
        with pytest.raises(ValueError):
            port.encode32(bad)


@pytest.mark.parametrize("cls", ["CodecConfig", "FrameConfig"])
def test_config_fields_and_defaults(cls):
    def spec(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert spec(getattr(port, cls)) == spec(getattr(ref, cls))
    assert getattr(port, cls)().__hash__ is not None  # frozen, hashable


def test_config_from_reference():
    rc = ref.FrameConfig(block_size=4096, checksum=False, min_profit=3)
    pc = config_from_reference(rc)
    assert isinstance(pc, port.FrameConfig)
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert config_from_reference(ref.CodecConfig()) == port.CodecConfig()
    with pytest.raises(ValueError):
        port.CodecConfig(block_size=(1 << 16) + 1)


def test_error_hierarchy():
    assert issubclass(port.CorruptInputError, port.SnappyError)
    assert issubclass(port.InputTooLargeError, port.SnappyError)


def test_port_imports_neither_jax_nor_snappy_tpu():
    code = (
        "import sys, snappy_tpu_torch\n"
        "import snappy_tpu_torch.ops.host, snappy_tpu_torch.ops.cuda_decode\n"
        "import snappy_tpu_torch.ops.kernels, snappy_tpu_torch.parallel.host\n"
        "import snappy_tpu_torch.ops.cuda_encode, snappy_tpu_torch.ops.encode_torch, snappy_tpu_torch.ops.route\n"
        "import snappy_tpu_torch.utils.profiling, snappy_tpu_torch.tools.bench, snappy_tpu_torch.tools.run_corpus\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'snappy_tpu', 'bench'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"port pulled in: {proc.stdout.strip()}"
