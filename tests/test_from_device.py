"""Device-resident ENCODE (compress_framed_from_device + the mesh
form): an HBM array becomes a framed stream with its per-chunk CRC-32C
computed on the (virtual, in tests) device before the bytes leave.
The emission must be byte-identical to compress_framed(bytes) — same
matcher, same CRCs — which keeps the ratio bound structural."""

import jax
import numpy as np
import pytest

native = pytest.importorskip("snappy_tpu.native")
if not native.available():  # pragma: no cover
    pytest.skip("native library unavailable", allow_module_level=True)

from snappy_tpu.errors import ChecksumError, CorruptError  # noqa: E402
from snappy_tpu.runtime import device_codec  # noqa: E402


def _mix(rng, n):
    return (b"from the device, framed " * 4096 + rng.randbytes(n))[:n]


class TestFromDevice:
    def test_roundtrip_boundary_sizes(self, rng):
        for n in (1, 1024, 65_536, 65_537, 131_072, 300_001):
            data = _mix(rng, n)
            arr = jax.device_put(np.frombuffer(data, np.uint8))
            fr = device_codec.compress_framed_from_device(arr)
            assert device_codec.decompress_framed(fr) == data, n

    def test_byte_identical_to_host_path(self, rng):
        """Same matcher, same CRC values: the from-device stream must
        equal compress_framed(bytes) exactly."""
        for n in (5_000, 65_536, 200_000):
            data = _mix(rng, n)
            arr = jax.device_put(np.frombuffer(data, np.uint8))
            assert (device_codec.compress_framed_from_device(arr)
                    == device_codec.compress_framed(data)), n

    def test_empty(self):
        arr = jax.device_put(np.zeros(0, np.uint8))
        fr = device_codec.compress_framed_from_device(arr)
        assert device_codec.decompress_framed(fr) == b""

    def test_incompressible_chunks_fall_back_uncompressed(self, rng):
        data = rng.randbytes(150_000)  # random: every chunk stays raw
        arr = jax.device_put(np.frombuffer(data, np.uint8))
        fr = device_codec.compress_framed_from_device(arr)
        assert len(fr) <= len(data) + 3 * 8 + 10  # headers only
        assert device_codec.decompress_framed(fr) == data

    def test_crc_detects_corruption(self, rng):
        """The CRCs embedded by the device graph must catch a flipped
        payload byte at decode time."""
        data = _mix(rng, 180_000)
        arr = jax.device_put(np.frombuffer(data, np.uint8))
        fr = bytearray(device_codec.compress_framed_from_device(arr))
        fr[40] ^= 0xFF
        with pytest.raises((ChecksumError, CorruptError)):
            device_codec.decompress_framed(bytes(fr))

    def test_multi_batch(self, rng, monkeypatch):
        monkeypatch.setattr(device_codec, "BATCH", 2)
        data = _mix(rng, 65536 * 7 + 123)
        arr = jax.device_put(np.frombuffer(data, np.uint8))
        fr = device_codec.compress_framed_from_device(arr)
        assert device_codec.decompress_framed(fr) == data

    def test_2d_input_flattens(self, rng):
        data = _mix(rng, 131_072)
        arr = jax.device_put(
            np.frombuffer(data, np.uint8).reshape(2, 65536))
        fr = device_codec.compress_framed_from_device(arr)
        assert device_codec.decompress_framed(fr) == data

    def test_wrong_dtype_raises(self):
        with pytest.raises(ValueError):
            device_codec.compress_framed_from_device(
                jax.device_put(np.zeros(8, np.float32)))

    def test_host_crc_fallback(self, rng, monkeypatch):
        monkeypatch.setattr(device_codec, "DEVICE_CRC", False)
        data = _mix(rng, 70_000)
        arr = jax.device_put(np.frombuffer(data, np.uint8))
        assert (device_codec.compress_framed_from_device(arr)
                == device_codec.compress_framed(data))


class TestMeshFromDevice:
    def test_loader_roundtrip_through_mesh(self, rng):
        """Full circle over the 8-device mesh: framed stream -> sharded
        loader rows (CRC-verified on each shard) -> sharded from-device
        encode -> framed stream -> original bytes; the re-encoded
        stream must equal the single-chip host emission."""
        from snappy_tpu.dist import mesh as dmesh

        data = _mix(rng, 65536 * 5 + 999)
        fr = device_codec.compress_framed(data)
        mesh = dmesh.make_mesh()
        rows, dlens, b = dmesh.sharded_decompress_framed_to_device(
            mesh, fr)
        fr2 = dmesh.sharded_compress_framed_from_device(
            mesh, rows, dlens[:b])
        assert device_codec.decompress_framed(fr2) == data
        assert fr2 == device_codec.compress_framed(data)

    def test_short_middle_row_per_record_semantics(self, rng):
        """A short MIDDLE row (not just the last) must still encode
        per-row records — the contiguous-buffer fast path only applies
        to full middle rows, so this exercises the gated fallback."""
        from snappy_tpu.dist import mesh as dmesh

        mesh = dmesh.make_mesh()
        n = mesh.devices.size
        rows_np = np.zeros((n, 65536), np.uint8)
        datas = [_mix(rng, 65536), _mix(rng, 777), _mix(rng, 65536)]
        for i, d in enumerate(datas):
            rows_np[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens = np.array([len(d) for d in datas], np.int32)
        recs = dmesh.sharded_encode_rows_to_chunks(
            mesh, jax.device_put(rows_np), lens)
        assert len(recs) == 3
        stream = bytes(device_codec.STREAM_ID_CHUNK) + b"".join(recs)
        assert (device_codec.decompress_framed(stream)
                == b"".join(datas))

    def test_empty_rows(self):
        from snappy_tpu.dist import mesh as dmesh

        mesh = dmesh.make_mesh()
        n = mesh.devices.size
        rows = jax.device_put(np.zeros((n, 65536), np.uint8))
        fr = dmesh.sharded_compress_framed_from_device(
            mesh, rows, np.zeros(0, np.int32))
        assert device_codec.decompress_framed(fr) == b""


def test_from_device_generator_fuzz(rng):
    """Generator-family fuzz for the from-device encode (mirrors the
    to_device sweep): 8 families x sizes, each array compressed from
    the (virtual) device and round-tripped, byte-identical to the
    host emission."""
    import jax

    nrng = np.random.default_rng(20260820 + 5)
    for t in range(16):
        kind = t % 8
        n = int(nrng.integers(1, 150_000))
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
            data = nrng.bytes(n // 2) + (b"abcdef" * 9000)[
                :max(0, n - n // 2)]
        elif kind == 5:
            data = nrng.integers(0, 3, n, dtype=np.uint8).tobytes()
        elif kind == 6:
            seed = nrng.bytes(min(n, 5000))
            data = (seed + nrng.bytes(60000) + seed + nrng.bytes(4000))[:n]
        else:
            w = [nrng.bytes(int(nrng.integers(2, 9))) for _ in range(30)]
            data = b"".join(
                w[int(i)] for i in nrng.integers(0, 30, n // 5 + 1))[:n]
        if not data:
            continue
        arr = jax.device_put(np.frombuffer(data, np.uint8))
        fr = device_codec.compress_framed_from_device(arr)
        assert device_codec.decompress_framed(fr) == data, (t, kind)
        assert fr == device_codec.compress_framed(data), (t, kind)


def test_compress_from_device_raw(rng):
    """Raw-format from-device encode: byte-identical to the production
    host encoder, round-trips, dtype-guarded; completes the
    to/from-device API matrix (framed has the device CRC; raw has no
    checksum so the documented division is fetch + host encode)."""
    import snappy_tpu

    for size in (1, 65535, 65536, 65537, 200_000):
        data = _mix(rng, size)
        arr = jax.device_put(np.frombuffer(data, np.uint8))
        got = snappy_tpu.compress_from_device(arr)
        assert snappy_tpu.decompress(got) == data
        assert got == snappy_tpu.compress(data)
    with pytest.raises(ValueError):
        snappy_tpu.compress_from_device(
            jax.device_put(np.zeros(4, np.int32)))
