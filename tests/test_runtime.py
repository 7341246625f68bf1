"""L2 runtime: production batched device codec vs the oracle, through the
public API backend registry."""


import pytest

import snappy_tpu
from conftest import make_corpus_samples
from snappy_tpu.errors import BadMagicError, ChecksumError, CorruptError
from snappy_tpu.runtime import device_codec
from snappy_tpu.spec import framing, reference

pa = pytest.importorskip("pyarrow")


def test_framed_roundtrip_multichunk(rng):
    # 3 chunks: compressible, incompressible, tail
    data = (b"hello world " * 11000)[:120000] + rng.randbytes(70000) + b"tail" * 10
    framed = device_codec.compress_framed(data)
    assert device_codec.decompress_framed(framed) == data
    # oracle framing decodes our stream; we decode oracle's
    assert framing.decompress_framed(framed) == data
    assert device_codec.decompress_framed(framing.compress_framed(data)) == data


def test_framed_empty_and_small(rng):
    for data in (b"", b"x", rng.randbytes(100)):
        framed = device_codec.compress_framed(data)
        assert device_codec.decompress_framed(framed) == data
        assert framing.decompress_framed(framed) == data


def test_raw_roundtrip(rng):
    for data in (b"", b"abc", (b"pattern" * 40000)[:150000], rng.randbytes(80000)):
        comp = device_codec.compress(data)
        assert reference.decompress(comp) == data
        assert device_codec.decompress(comp) == data
        if data:
            assert pa.decompress(comp, len(data), codec="snappy", asbytes=True) == data


def test_ratio_bound_device_path(rng, monkeypatch):
    data = b"".join(make_corpus_samples(rng, sizes=(1000, 65536)))
    # id path: the C++ matcher's emission IS the reference emission
    assert device_codec.compress(data) == reference.compress(data)
    # the jnp encoder (no native library) stays <= min(reference, C++)
    monkeypatch.setattr(device_codec, "_use_id", lambda: False)
    comp = device_codec.compress(data)
    ref = min(
        len(reference.compress(data)),
        len(pa.compress(data, codec="snappy", asbytes=True)),
    )
    assert len(comp) <= ref


def test_framed_errors(rng):
    data = rng.randbytes(5000)
    framed = bytearray(device_codec.compress_framed(data))
    with pytest.raises(BadMagicError):
        device_codec.decompress_framed(b"nope" + bytes(framed))
    framed[-1] ^= 0xFF
    with pytest.raises((ChecksumError, CorruptError)):
        device_codec.decompress_framed(bytes(framed))


def test_api_backend_jnp(rng):
    data = b"api-level drive " * 1000
    c = snappy_tpu.compress(data, backend="jnp")
    assert snappy_tpu.decompress(c, backend="jnp") == data
    f = snappy_tpu.compress_framed(data, backend="jnp")
    assert snappy_tpu.decompress_framed(f, backend="jnp") == data
    assert snappy_tpu.decompress_framed(f, backend="oracle") == data


def test_batch_boundary(rng, monkeypatch):
    # force tiny batches so multiple device calls happen
    monkeypatch.setattr(device_codec, "BATCH", 2)
    data = rng.randbytes(65536 * 5 + 123)
    framed = device_codec.compress_framed(data)
    assert device_codec.decompress_framed(framed) == data


def _frame_one_chunk(payload_elements: bytes, uncompressed: bytes) -> bytes:
    """Hand-assemble a framed stream holding one compressed chunk whose
    raw-snappy body is varint(len) + payload_elements."""
    from snappy_tpu.spec.crc32c import crc32c
    from snappy_tpu.spec.format import (
        STREAM_ID_CHUNK, mask_crc, put_uvarint,
    )

    body = put_uvarint(len(uncompressed)) + payload_elements
    crc = mask_crc(crc32c(uncompressed))
    blen = len(body) + 4
    return (
        STREAM_ID_CHUNK
        + bytes((0x00, blen & 0xFF, (blen >> 8) & 0xFF, (blen >> 16) & 0xFF))
        + crc.to_bytes(4, "little")
        + body
    )


def _one_byte_literals(n: int) -> tuple[bytes, bytes]:
    """Worst-ratio valid stream: n one-byte literal elements (2B each)."""
    data = bytes(range(256)) * (n // 256 + 1)
    data = data[:n]
    elems = b"".join(bytes((0x00, b)) for b in data)
    return elems, data


def test_oversized_payload_host_fallback():
    # ADVICE r1: payload > _DECODE_CMAX is VALID (1-byte literals expand
    # ~2x) and must decode via host fallback, not raise CorruptError
    elems, data = _one_byte_literals(40000)  # payload 80001 > 66560
    framed = _frame_one_chunk(elems, data)
    assert len(elems) + 1 + 2 > device_codec._DECODE_CMAX
    assert device_codec.decompress_framed(framed) == data
    assert framing.decompress_framed(framed) == data


def test_tag_cap_hybrid_path():
    # ADVICE r1: ~33k one-byte literals fit the device row but overflowed
    # the old _T_CAP=33024 record buffer on the hybrid host-parse path
    elems, data = _one_byte_literals(33100)  # payload 66203 <= 66560
    framed = _frame_one_chunk(elems, data)
    assert len(elems) + 1 + 2 <= device_codec._DECODE_CMAX
    assert device_codec.decompress_framed(framed) == data


def test_concurrent_compress_framed_threads(rng, monkeypatch):
    """Library thread-safety: concurrent compress_framed calls from
    user threads must not share encode scratch (the r5 review found a
    module-global element buffer that corrupted concurrent emissions;
    it is thread-local now).  Each thread round-trips its own distinct
    payload many times; any cross-talk shows as a mismatch."""
    from concurrent.futures import ThreadPoolExecutor

    from snappy_tpu.runtime import device_codec

    payloads = [
        (bytes([65 + i]) * 70_000 + rng.randbytes(80_000))
        for i in range(4)
    ]
    expected = [device_codec.compress_framed(p) for p in payloads]

    def worker(i):
        for _ in range(6):
            fr = device_codec.compress_framed(payloads[i])
            assert fr == expected[i], f"thread {i} emission cross-talk"
            assert device_codec.decompress_framed(fr) == payloads[i]
        return i

    with ThreadPoolExecutor(4) as pool:
        assert sorted(pool.map(worker, range(4))) == [0, 1, 2, 3]


def test_framed_edge_inputs(monkeypatch):
    """Spec-legal oddities a foreign writer may emit (r5 adversarial
    probe): an empty compressed chunk (varint 0, no elements), repeated
    stream identifiers mid-stream ("may repeat", spec §8.2), and
    trailing junk after a chunk's element (must reject, matching C++
    snappy's full-consumption rule)."""
    import numpy as np

    from snappy_tpu import native
    from snappy_tpu.errors import CorruptError
    from snappy_tpu.runtime import device_codec as dc
    from snappy_tpu.spec.crc32c import crc32c
    from snappy_tpu.spec.format import STREAM_ID_CHUNK, mask_crc

    def rec(ctype, payload, crc_data):
        body = len(payload) + 4
        return (bytes((ctype, body & 255, (body >> 8) & 255,
                       (body >> 16) & 255))
                + mask_crc(crc32c(crc_data)).to_bytes(4, "little")
                + payload)

    # empty compressed chunk
    fr = STREAM_ID_CHUNK + rec(0x00, b"\x00", b"")
    assert dc.decompress_framed(fr) == b""

    data = b"edge inputs " * 2000
    el = native.compress(data) if native.available() else None
    if el is None:
        return
    # repeated stream identifier between data chunks
    fr = (STREAM_ID_CHUNK + rec(0x00, el, data)
          + STREAM_ID_CHUNK + rec(0x00, el, data))
    assert dc.decompress_framed(fr) == data * 2

    # trailing junk after the element: reject, never decode silently
    fr = STREAM_ID_CHUNK + rec(0x00, el + b"\xaa\xbb", data)
    import pytest

    with pytest.raises(CorruptError):
        dc.decompress_framed(fr)


def test_compress_framed_id_path_variants(rng, monkeypatch):
    """The id native-assembly fast path must stay byte-identical to
    the reference framing across its gate variants: device CRC on/off,
    multi-batch, and the generic per-chunk path (no native library)."""
    from snappy_tpu import native
    from snappy_tpu.spec import framing

    if not native.available():
        pytest.skip("native build unavailable")
    data = make_corpus_samples(rng, sizes=(3 * 65536 + 777,))[0]
    want = framing.compress_framed(data)

    assert device_codec.compress_framed(data) == want
    # host-CRC form (SNAPPY_TPU_DEVICE_CRC=0)
    monkeypatch.setattr(device_codec, "DEVICE_CRC", False)
    assert device_codec.compress_framed(data) == want
    monkeypatch.setattr(device_codec, "DEVICE_CRC", True)
    # multi-batch through the fast path
    monkeypatch.setattr(device_codec, "BATCH", 2)
    assert device_codec.compress_framed(data) == want
    # without the native library the generic jnp path must round-trip
    monkeypatch.setattr(device_codec, "_use_id", lambda: False)
    assert framing.decompress_framed(device_codec.compress_framed(data)) == data
