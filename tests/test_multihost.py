"""Multi-host planner + per-host compression units: assembling the
per-host outputs must reproduce the single-host framed stream exactly
(bit-for-bit parity requirement, BASELINE config 5)."""

import numpy as np

from snappy_tpu.dist import multihost
from snappy_tpu.runtime import device_codec
from snappy_tpu.spec.format import STREAM_ID_CHUNK


def test_plan_ranges():
    assert multihost.plan_ranges(0, 4) == [(0, 0)] * 4
    r = multihost.plan_ranges(65536 * 10 + 5, 4)
    assert sum(c for _, c in r) == 11
    assert r[0][0] == 0
    for (s1, c1), (s2, _) in zip(r, r[1:]):
        assert s2 == s1 + c1
    # balance within one chunk
    counts = [c for _, c in r]
    assert max(counts) - min(counts) <= 1


def test_two_host_assembly_parity(rng):
    data = (b"multi host corpus " * 9000)[:100000] + rng.randbytes(120000)
    single = device_codec.compress_framed(data)

    ranges = multihost.plan_ranges(len(data), 2)
    parts = []
    for start, cnt in ranges:
        lo = start * 65536
        hi = min(len(data), (start + cnt) * 65536)
        bodies, lengths = multihost.host_compress_framed(data[lo:hi], start)
        assert multihost.gather_lengths(lengths) is lengths  # 1-process path
        parts.append(b"".join(bodies))
    assembled = bytes(STREAM_ID_CHUNK) + b"".join(parts)
    assert assembled == single
    assert device_codec.decompress_framed(assembled) == data


def test_plan_chunk_ranges():
    r = multihost.plan_chunk_ranges(11, 4)
    assert sum(c for _, c in r) == 11
    assert r[0] == (0, 3)
    counts = [c for _, c in r]
    assert max(counts) - min(counts) <= 1
    assert multihost.plan_chunk_ranges(0, 3) == [(0, 0)] * 3


def test_host_decompress_parity(rng):
    """N-way decompress split reassembles bit-for-bit, with per-host
    GB/s stats (BASELINE config 5, decompress side)."""
    data = (b"decompress side " * 9000)[:110000] + rng.randbytes(130000) + b"tail"
    framed = device_codec.compress_framed(data)
    for n_hosts in (1, 2, 3):
        out = bytearray()
        pieces = []
        for pid in range(n_hosts):
            base, blob, total, stats = multihost.host_decompress_framed(
                framed, pid, n_hosts
            )
            assert total == len(data)
            assert stats["bytes"] == len(blob)
            pieces.append((base, blob))
        pieces.sort()
        for base, blob in pieces:
            assert base == len(out)  # contiguous, ordered
            out += blob
        assert bytes(out) == data


def test_two_host_parity_flat_engines(rng, monkeypatch):
    """Config-5 parity on the production id path: per-host compress
    assembly and decompress ranges must stay bit-identical."""
    data = (b"flat multihost " * 4000)[:50000] + rng.randbytes(40000)
    single = device_codec.compress_framed(data)

    ranges = multihost.plan_ranges(len(data), 2)
    parts = []
    for start, cnt in ranges:
        lo = start * 65536
        hi = min(len(data), (start + cnt) * 65536)
        bodies, _ = multihost.host_compress_framed(data[lo:hi], start)
        parts.append(b"".join(bodies))
    assert bytes(STREAM_ID_CHUNK) + b"".join(parts) == single

    # decompress side: each host decodes its chunk range
    out = bytearray(len(data))
    for pid in range(2):
        base, blob, total, _ = multihost.host_decompress_framed(single, pid, 2)
        assert total == len(data)
        out[base : base + len(blob)] = blob
    assert bytes(out) == data


def test_host_decompress_detects_corruption(rng):
    from snappy_tpu.errors import ChecksumError, CorruptError

    import pytest

    data = rng.randbytes(140000)
    framed = bytearray(device_codec.compress_framed(data))
    framed[-1] ^= 0xFF
    with pytest.raises((ChecksumError, CorruptError)):
        # the corrupted tail chunk lands in the LAST host's range
        multihost.host_decompress_framed(bytes(framed), 1, 2)


def test_host_decompress_framed_to_device_partition(rng):
    """Multi-host data loading: per-host device-resident chunk ranges
    tile the stream exactly (every chunk lands on exactly one host,
    rows bit-equal to the host decode), zero collectives."""
    import jax
    import numpy as np

    from snappy_tpu.dist import mesh as dmesh, multihost as mh
    from snappy_tpu.runtime import device_codec

    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs 4 devices")
    data = (b"multihost loader " * 9000)[:150_000] + rng.randbytes(80_000)
    fr = device_codec.compress_framed(data)
    mesh = dmesh.make_mesh(2)
    got = {}
    for pid in range(2):
        rows, dlens, lo, cnt = mh.host_decompress_framed_to_device(
            fr, pid, 2, mesh=mesh)
        for i in range(cnt):
            got[lo + i] = np.asarray(rows[i, : dlens[i]]).tobytes()
    assert b"".join(got[i] for i in sorted(got)) == data
    assert sorted(got) == list(range(len(got)))


def test_host_compress_from_device_full_circle(rng, monkeypatch):
    """From-device multi-host encode (round 5): each simulated host
    loads its chunk range onto its mesh (loader), re-encodes it from
    the device rows, and the assembled stream — stream id + records at
    allgathered offsets — is byte-identical to the single-host
    production emission and round-trips."""
    import jax
    import numpy as np

    from snappy_tpu.dist import mesh as dmesh, multihost as mh
    from snappy_tpu.runtime import device_codec
    from snappy_tpu.spec.format import STREAM_ID_CHUNK

    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs 4 devices")
    data = (b"from-device multihost " * 9000)[:200_000] + rng.randbytes(
        70_000)
    fr = device_codec.compress_framed(data)
    mesh = dmesh.make_mesh(2)
    per_host = {}
    for pid in range(2):
        rows, dlens, lo, cnt = mh.host_decompress_framed_to_device(
            fr, pid, 2, mesh=mesh)
        bodies, lengths = mh.host_compress_framed_from_device(
            rows, dlens, mesh=mesh)
        assert len(bodies) == cnt
        per_host[pid] = (lo, bodies, lengths)
    # assembly contract: lengths allgather (simulated), exclusive scan
    all_lengths = np.concatenate(
        [per_host[p][2] for p in range(2)])
    out = bytearray(STREAM_ID_CHUNK)
    for p in range(2):
        for b in per_host[p][1]:
            out += b
    assert bytes(out) == fr  # byte-identical to the single-host stream
    assert device_codec.decompress_framed(bytes(out)) == data
    assert int(all_lengths.sum()) == len(fr) - len(STREAM_ID_CHUNK)
