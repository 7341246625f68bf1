"""Device-resident decode APIs (id data-loader path):
decompress_to_device (raw, identity seg staging) and
decompress_framed_to_device (framed, id rows + device CRC).  The id path
runs on every platform, so on the CPU test platform the code path —
staging, H2D, device assembly, err-only fetch — is the production one."""

import numpy as np
import pytest

native = pytest.importorskip("snappy_tpu.native")
if not native.available():  # pragma: no cover
    pytest.skip("native library unavailable", allow_module_level=True)

from snappy_tpu.errors import ChecksumError, CorruptError  # noqa: E402
from snappy_tpu.runtime import device_codec  # noqa: E402
from snappy_tpu.spec.format import put_uvarint  # noqa: E402


def _mix(rng, n):
    body = (b"to the device, verbatim " * 4096 + rng.randbytes(n))[:n]
    return body


class TestRawToDevice:
    def test_roundtrip_boundary_sizes(self, rng):
        for n in (1, 1024, 65_536, 65_537, 131_072 + 13, 300_000):
            data = _mix(rng, n)
            raw = native.compress(data)
            dev = device_codec.decompress_to_device(raw)
            assert bytes(np.asarray(dev)) == data, n

    def test_foreign_stream(self, rng):
        import pyarrow as pa

        data = _mix(rng, 200_000)
        raw = pa.compress(data, codec="snappy", asbytes=True)
        dev = device_codec.decompress_to_device(raw)
        assert bytes(np.asarray(dev)) == data

    def test_straddling_literal_and_copy(self, rng):
        lit = rng.randbytes(70_000)            # literal straddles 64 KiB
        echo = lit[60_000:60_100] * 40     # copies reach across
        data = lit + echo + rng.randbytes(10_000)
        raw = native.compress(data)
        dev = device_codec.decompress_to_device(raw)
        assert bytes(np.asarray(dev)) == data

    def test_truncated_raises(self, rng):
        raw = native.compress(rng.randbytes(150_000))
        with pytest.raises(CorruptError):
            device_codec.decompress_to_device(raw[: len(raw) // 2])

    def test_oversized_offset_falls_back(self):
        """A format-legal copy offset past the 64 KiB carry is not
        id-seg-stageable: the host decoder must take over (same bytes
        out)."""
        rng = np.random.default_rng(5)
        lit = rng.bytes(70_000)
        body = bytearray(put_uvarint(70_000 + 4))
        n = len(lit) - 1
        body += bytes([63 << 2, n & 255, (n >> 8) & 255,
                       (n >> 16) & 255, (n >> 24) & 255])
        body += lit
        off = 66_000                       # > 65536: beyond the carry
        body += bytes([(3 << 2) | 3, off & 255, (off >> 8) & 255,
                       (off >> 16) & 255, (off >> 24) & 255])
        raw = bytes(body)
        want = lit + lit[70_000 - off:70_000 - off + 4]
        assert native.decompress(raw) == want  # oracle cross-check
        dev = device_codec.decompress_to_device(raw)
        assert bytes(np.asarray(dev)) == want

    def test_empty_stream(self):
        raw = native.compress(b"")
        dev = device_codec.decompress_to_device(raw)
        assert bytes(np.asarray(dev)) == b""

    def test_many_batches_no_staging_alias(self, rng,
                                           monkeypatch):
        """Regression: device_put
        zero-copy aliases host numpy buffers, so a reused staging
        buffer corrupts earlier batches' device arrays once the stream
        spans more batches than the buffer pool.  BATCH=2 makes a
        ~2 MiB stream cover 16 batches (the production shape at 12+
        MiB); every byte must survive the final concatenate."""
        monkeypatch.setattr(device_codec, "BATCH", 2)
        data = _mix(rng, 65536 * 31 + 4242)
        raw = native.compress(data)
        dev = device_codec.decompress_to_device(raw)
        got = bytes(np.asarray(dev))
        assert got[:65536] == data[:65536]  # first batch intact
        assert got == data

    def test_id_seg_stager_parity_vs_host(self, rng):
        """Per-segment identity staging reproduces the host decode at
        every 64 KiB boundary split."""
        data = (b"the quick brown fox " * 9000)[:170_000]
        raw = native.compress(data)
        dev = device_codec.decompress_to_device(raw)
        assert bytes(np.asarray(dev)) == native.decompress(raw) == data


class TestFramedToDevice:
    def test_roundtrip_and_residency(self, rng):
        data = _mix(rng, 500_000)
        fr = device_codec.compress_framed(data)
        dev = device_codec.decompress_framed_to_device(fr)
        assert dev.dtype == np.uint8 and dev.shape == (len(data),)
        assert bytes(np.asarray(dev)) == data

    def test_mixed_uncompressed_chunks(self, rng):
        # random 64 KiB blocks emit CHUNK_UNCOMPRESSED; text compresses
        data = rng.randbytes(200_000) + b"framed mix " * 30_000
        fr = device_codec.compress_framed(data)
        dev = device_codec.decompress_framed_to_device(fr)
        assert bytes(np.asarray(dev)) == data

    def test_device_crc_rejects_corruption(self, rng):
        data = (b"verify me on the device " * 9000)[:180_000]
        fr = bytearray(device_codec.compress_framed(data))
        fr[40] ^= 0xFF  # flip a payload byte in the first chunk body
        with pytest.raises((ChecksumError, CorruptError)):
            device_codec.decompress_framed_to_device(bytes(fr))

    def test_verify_false_skips_crc_raise(self, rng):
        data = (b"no verify " * 9000)[:90_000]
        fr = device_codec.compress_framed(data)
        dev = device_codec.decompress_framed_to_device(
            fr, verify_checksums=False)
        assert bytes(np.asarray(dev)) == data

    def test_ragged_chunks_fall_back(self, rng):
        """Non-64 KiB interior chunks (a non-default writer) can't use
        the reshape assembly: the host path + device_put must kick in,
        same bytes out."""
        data = _mix(rng, 10_000)
        fr = device_codec.compress_framed(data, chunk_size=2048)
        dev = device_codec.decompress_framed_to_device(fr)
        assert bytes(np.asarray(dev)) == data

    def test_multi_batch_assembly_order(self, rng, monkeypatch):
        """More chunks than one device batch: rows must reassemble in
        chunk order across batches."""
        monkeypatch.setattr(device_codec, "BATCH", 2)
        data = _mix(rng, 65536 * 5 + 777)
        fr = device_codec.compress_framed(data)
        dev = device_codec.decompress_framed_to_device(fr)
        assert bytes(np.asarray(dev)) == data


def test_to_device_generator_fuzz(rng):
    """Bounded version of the round-4 400-case sweep (0 failures):
    8 generator families x own + foreign raw streams + framed, all
    through the id/to_device paths."""
    import pyarrow as pa

    nrng = np.random.default_rng(20260820)
    for t in range(24):
        kind = t % 8
        n = int(nrng.integers(0, 150_000))
        if kind == 0:
            data = nrng.bytes(n)
        elif kind == 1:
            data = (b"the quick brown fox " * 8000)[:n]
        elif kind == 2:
            data = bytes([int(nrng.integers(65, 70))]) * n
        elif kind == 3:
            p = int(nrng.integers(1, 200)) or 1
            data = (nrng.bytes(p) * (n // p + 1))[:n]
        elif kind == 4:
            data = nrng.bytes(n // 2) + (b"abcdef" * 9000)[:max(0, n - n // 2)]
        elif kind == 5:
            data = nrng.integers(0, 3, n, dtype=np.uint8).tobytes()
        elif kind == 6:
            seed = nrng.bytes(min(n, 5000))
            data = (seed + nrng.bytes(60000) + seed + nrng.bytes(4000))[:n]
        else:
            w = [nrng.bytes(int(nrng.integers(2, 9))) for _ in range(30)]
            data = b"".join(
                w[int(i)] for i in nrng.integers(0, 30, n // 5))[:n]
        for raw in (native.compress(data),
                    pa.compress(data, codec="snappy", asbytes=True)):
            assert bytes(np.asarray(
                device_codec.decompress_to_device(raw))) == data, (t, kind)
        fr = device_codec.compress_framed(data)
        assert bytes(np.asarray(
            device_codec.decompress_framed_to_device(fr))) == data, (t, kind)
