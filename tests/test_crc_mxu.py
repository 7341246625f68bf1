"""Device CRC-32C kernel: bit-exact vs the table oracle at every length
class (empty, partial, full chunks) and data pattern."""

import random

import numpy as np
import pytest

from snappy_tpu.kernels.crc32c_jnp import CHUNK, crc32c_chunks
from snappy_tpu.spec.crc32c import crc32c as oracle


def test_crc_mxu_matches_oracle(rng):
    lengths = [0, 1, 7, 255, 256, 257, 4096, 65535, 65536, 12345]
    rows = np.zeros((len(lengths), CHUNK), dtype=np.uint8)
    for i, n in enumerate(lengths):
        rows[i, :n] = np.frombuffer(rng.randbytes(n), np.uint8)
    got = np.asarray(crc32c_chunks(rows, np.array(lengths, np.int32)))
    for i, n in enumerate(lengths):
        want = oracle(rows[i, :n].tobytes())
        assert int(got[i]) == want, f"len={n}: got {got[i]:#x} want {want:#x}"


def test_crc_mxu_known_vectors():
    rows = np.zeros((2, CHUNK), dtype=np.uint8)
    rows[0, :9] = np.frombuffer(b"123456789", np.uint8)
    rows[1, :32] = 0xFF
    got = np.asarray(crc32c_chunks(rows, np.array([9, 32], np.int32)))
    assert int(got[0]) == 0xE3069283
    assert int(got[1]) == 0x62A8AB43


_LENGTHS = (0, 1, 7, 255, 256, 257, 4096, 65535, 65536)
_PATTERNS = ("zeros", "ff", "random", "text")


def _pattern(kind: str, n: int) -> bytes:
    if kind == "zeros":
        return bytes(n)
    if kind == "ff":
        return b"\xff" * n
    if kind == "random":
        return random.Random(n).randbytes(n)
    return (b"the quick brown fox jumps over the lazy dog. " * (n // 45 + 1))[:n]


@pytest.mark.parametrize("kind", _PATTERNS)
@pytest.mark.parametrize("n", _LENGTHS)
def test_crc_chunks_vs_table_oracle(n, kind):
    data = _pattern(kind, n)
    rows = np.full((1, CHUNK), 0xA5, np.uint8)  # bytes past n must not count
    rows[0, :n] = np.frombuffer(data, np.uint8)
    got = np.asarray(crc32c_chunks(rows, np.array([n], np.int32)))
    assert int(got[0]) == oracle(data)
