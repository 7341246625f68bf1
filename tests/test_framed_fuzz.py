"""Corruption/truncation fuzz through the *device* framed decode paths
(VERDICT r1 #8): every mutation must either raise a documented error or
decode to the exact original bytes (mutations in padding/skippable
regions are legal) — never return wrong bytes.

Runs the same sweep through every decode engine: the id path (the
production engine whenever the native library is present), and, with
the id path switched off, the hybrid (host-parse) and pure-device jnp
decoders.
"""

import random

import pytest

from snappy_tpu.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    SnappyError,
    UnsupportedError,
)
from snappy_tpu.runtime import device_codec

_ERRS = (BadMagicError, ChecksumError, CorruptError, UnsupportedError, SnappyError)


def _fuzz_sweep(data: bytes, framed: bytes, rng: random.Random, n_mut: int):
    wrong = 0
    for k in range(n_mut):
        mut = bytearray(framed)
        kind = k % 3
        if kind == 0:  # flip a random byte
            i = rng.randrange(len(mut))
            mut[i] ^= rng.randrange(1, 256)
        elif kind == 1:  # truncate
            mut = mut[: rng.randrange(1, len(mut))]
        else:  # splice garbage run
            i = rng.randrange(len(mut))
            n = min(len(mut) - i, rng.randrange(1, 64))
            mut[i : i + n] = rng.randbytes(n)
        try:
            out = device_codec.decompress_framed(bytes(mut))
        except _ERRS:
            continue
        except OverflowError:
            # a mutated 3-byte chunk-length header may describe a chunk
            # larger than the buffer; must have been caught above
            raise
        if out != data:
            wrong += 1
    assert wrong == 0, f"{wrong}/{n_mut} mutations returned wrong bytes"


@pytest.fixture
def corpus(rng):
    data = (b"fuzz corpus line " * 5000)[:70000] + rng.randbytes(40000)
    return data, device_codec.compress_framed(data)


def test_fuzz_hybrid_engine(corpus, rng, monkeypatch):
    data, framed = corpus
    assert device_codec.HOST_PARSE
    monkeypatch.setattr(device_codec, "_use_id", lambda: False)
    _fuzz_sweep(data, framed, rng, 60)


def test_fuzz_pure_device_engine(corpus, rng, monkeypatch):
    data, framed = corpus
    monkeypatch.setattr(device_codec, "_use_id", lambda: False)
    monkeypatch.setattr(device_codec, "HOST_PARSE", False)
    _fuzz_sweep(data, framed, rng, 40)


def test_fuzz_pallas_engine(corpus, rng, monkeypatch):
    # the id path (the production engine, native library present)
    data, framed = corpus
    assert device_codec._use_id()
    _fuzz_sweep(data, framed, rng, 24)


def test_fuzz_no_device_crc(corpus, rng, monkeypatch):
    # host-CRC verification path
    data, framed = corpus
    monkeypatch.setattr(device_codec, "DEVICE_CRC", False)
    _fuzz_sweep(data, framed, rng, 30)


def test_differential_sweep_vs_cxx_snappy():
    """Standing differential sweep against real C++ snappy (pyarrow),
    bounded form of the r5 400-case run (0 failures): both encoders
    cross-decode through C++; the np matcher's emission stays <=
    min(go-style(=native), C++) per input — the native backend's own
    contract is byte-exactness to the go-style reference, which C++
    snappy legitimately beats on some low-entropy inputs."""
    import numpy as np

    pa = pytest.importorskip("pyarrow")
    from snappy_tpu import api, native

    if not native.available():  # pragma: no cover
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(0xD1FF)
    for t in range(60):
        kind = t % 6
        n = int(rng.integers(0, 120_000))
        if kind == 0:
            data = rng.bytes(n)
        elif kind == 1:
            data = (b"differential sweep " * 20000)[:n]
        elif kind == 2:
            p = int(rng.integers(1, 300))
            data = (rng.bytes(p) * (n // p + 1))[:n]
        elif kind == 3:
            data = rng.integers(0, 5, n, dtype=np.uint8).tobytes()
        elif kind == 4:
            data = (rng.bytes(n // 3) + (b"xyz" * 40000)[:n - n // 3]
                    if n else b"")
        else:
            s = rng.bytes(min(n, 3000))
            data = (s + rng.bytes(50000) + s)[:n]
        cxx = pa.compress(data, codec="snappy", asbytes=True)
        nat = api.compress(data, backend="native")
        np_out = api.compress(data, backend="np")
        for ours in (nat, np_out):
            assert pa.decompress(
                ours, len(data), codec="snappy", asbytes=True) == data, t
        assert len(np_out) <= min(len(cxx), len(nat)), t
        assert api.decompress(cxx, backend="native") == data, t
