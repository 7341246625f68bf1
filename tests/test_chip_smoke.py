"""chip_smoke.py's phases rehearsed on the CPU at tiny sizes (the script
itself refuses anything but a GPU, which these tests check too): the
same public entry points and comparisons the chip run makes."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from snappy_tpu import native  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable")

N = 3 * 65536 + 777  # three full chunks and a ragged tail


@pytest.fixture(scope="module")
def data():
    return chip_smoke.make_data(N)


@pytest.fixture(scope="module")
def framed(data):
    return chip_smoke.phase_compress(data, sample=4)


def test_make_data_exact_and_seeded():
    a = chip_smoke.make_data(100_000)
    assert len(a) == 100_000 and a == chip_smoke.make_data(100_000)


def test_phase_compress(data, framed):
    assert framed == native.compress_framed(data)


def test_phase_decompress_and_from_device(data, framed):
    chip_smoke.phase_decompress(framed, data)
    chip_smoke.phase_from_device(data, framed)


def test_phase_loader_rejects_on_device(data, framed):
    chip_smoke.phase_loader(framed, data)


def test_phase_raw(data):
    chip_smoke.phase_raw(data)


def test_phase_crc_and_timing(data):
    chip_smoke.phase_crc(data, rows=2, tail=100)
    t = chip_smoke.time_crc(data, rows=2, reps=1)
    assert set(t) == {"crc32c_chunks", "_decode_id_and_crc"}
    assert all(v["host_clock_s_per_call"] > 0 for v in t.values())


def test_phase_checkpoint():
    assert chip_smoke.phase_checkpoint(1 << 16) > 1 << 16


def test_sharded_path_on_virtual_mesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    chip_smoke.run_sharded(2 * 65536 + 99, 4, lambda what, t0: None)


def test_quarter_distinct():
    q = chip_smoke.quarter_distinct(b"\x00\x01" * 10, 4)
    parts = [q[i * 20:(i + 1) * 20] for i in range(4)]
    assert len(set(parts)) == 4 and parts[0] == b"\x00\x01" * 10


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err
