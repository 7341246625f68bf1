"""L3 mesh sharding on the virtual 8-device CPU mesh: the multi-chip DP
path must produce byte-identical results to single-device encode, with
zero tolerance for device-order dependence."""

import numpy as np
import pytest

import jax

from snappy_tpu.dist import mesh as dmesh
from snappy_tpu.kernels import encode_np
from snappy_tpu.spec import reference


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return dmesh.make_mesh(8)


def _mk_batch(rng, n_blocks, bmax):
    blocks = np.zeros((n_blocks, bmax), dtype=np.uint8)
    lens = np.zeros(n_blocks, dtype=np.int32)
    for i in range(n_blocks):
        kind = i % 3
        if kind == 0:
            row = (b"mesh sharded block data " * 60)[: bmax - i]
        elif kind == 1:
            row = rng.randbytes(bmax // 2 + i)
        else:
            row = b"R" * (bmax // 3)
        blocks[i, : len(row)] = np.frombuffer(row, dtype=np.uint8)
        lens[i] = len(row)
    return blocks, lens


def test_sharded_encode_matches_reference(rng, mesh8):
    bmax = 2048
    blocks, lens = _mk_batch(rng, 16, bmax)
    comp, clen, ok = dmesh.sharded_encode(mesh8, blocks, lens, bmax)
    assert ok.all()
    for i in range(16):
        blob = comp[i, : clen[i]].tobytes()
        want = encode_np.encode_block_np(blocks[i, : lens[i]].tobytes())
        assert blob == want, f"block {i} diverged under sharding"


def test_roundtrip_step(rng, mesh8):
    bmax = 2048
    blocks, lens = _mk_batch(rng, 16, bmax)
    comp, clen, ok, offsets, out, err, match = dmesh.roundtrip_step(
        mesh8, blocks, lens, bmax
    )
    assert np.asarray(ok).all()
    assert (np.asarray(err) == 0).all()
    assert bool(np.asarray(match))
    cl = np.asarray(clen)
    assert (np.asarray(offsets) == np.cumsum(cl) - cl).all()


def test_decode_sharded(rng, mesh8):
    bmax = 2048
    samples = [rng.randbytes(500), b"Q" * 1500, (b"ab" * 900)[:1800]] * 4
    cmax = 2048
    B = len(samples)
    comp = np.zeros((B, cmax), dtype=np.uint8)
    starts = np.zeros(B, dtype=np.int32)
    clens = np.zeros(B, dtype=np.int32)
    dlens = np.zeros(B, dtype=np.int32)
    from snappy_tpu.spec.format import read_uvarint

    for i, s in enumerate(samples):
        c = reference.compress(s)
        comp[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        d, h = read_uvarint(c, 0)
        starts[i], clens[i], dlens[i] = h, len(c), d
    out, err = dmesh.sharded_decode(mesh8, comp, starts, clens, dlens, out_max=bmax)
    assert (err == 0).all()
    for i, s in enumerate(samples):
        assert out[i, : len(s)].tobytes() == s


def test_sharded_id_decode_and_enc_crc(rng, mesh8):
    """The id path over the mesh: each device slices its staged image +
    verifies CRC (decode), and CRCs the raw blocks (encode side) —
    bit-exact vs the host, and identical on 1 vs 8 devices."""
    from snappy_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    bmax = 4096
    blocks, lens = _mk_batch(rng, 12, bmax)  # 12: not a mesh multiple
    raw = [blocks[i, : lens[i]].tobytes() for i in range(12)]
    elems = [native.compress(b) for b in raw]

    ib, idlens, iwant = dmesh.stage_dec_id_batch(elems)
    out8, err8 = dmesh.sharded_decode_id(mesh8, ib, idlens, iwant)
    assert (err8 == 0).all()
    mesh1 = dmesh.make_mesh(1)
    out1, err1 = dmesh.sharded_decode_id(mesh1, ib, idlens, iwant)
    assert (out8 == out1).all() and (err1 == 0).all()
    for i, b in enumerate(raw):
        assert out8[i, : len(b)].tobytes() == b

    # a flipped staged byte must flag err 100 on its row only
    ib_bad = ib.copy()
    ib_bad[3, 100] ^= 0xFF
    _, errb = dmesh.sharded_decode_id(mesh8, ib_bad, idlens, iwant)
    assert errb[3] == 100 and (np.delete(errb, 3) == 0).all()

    blocks64 = np.zeros((12, 65536), np.uint8)
    blocks64[:, :bmax] = blocks
    crcs = dmesh.sharded_crc(mesh8, blocks64, lens)
    for i, b in enumerate(raw):
        assert int(crcs[i]) == native.crc32c(b)


def test_sharded_framed_to_device_loader(rng, mesh8):
    """Stream-level mesh data loader: a framed stream lands sharded over
    the mesh, rows match the host decode, CRC flags corruption, and 1-
    vs 8-device results are identical."""
    from snappy_tpu import native
    from snappy_tpu.errors import ChecksumError
    from snappy_tpu.runtime import device_codec

    if not native.available():
        pytest.skip("native library unavailable")
    data = (b"sharded loader " * 9000)[:100_000] + rng.randbytes(70_000)
    fr = device_codec.compress_framed(data)

    rows8, dlens, b = dmesh.sharded_decompress_framed_to_device(mesh8, fr)
    got = b"".join(
        np.asarray(rows8[i, : dlens[i]]).tobytes() for i in range(b))
    assert got == data
    mesh1 = dmesh.make_mesh(1)
    rows1, dlens1, b1 = dmesh.sharded_decompress_framed_to_device(mesh1, fr)
    assert b1 == b and (dlens1 == dlens).all()
    assert (np.asarray(rows8)[:b] == np.asarray(rows1)[:b]).all()

    # corruption surfaces at whichever layer sees it first: the
    # validating id walk (CorruptError) or the device CRC
    # (ChecksumError) — a flipped payload byte must never decode
    from snappy_tpu.errors import CorruptError

    bad = bytearray(fr)
    bad[40] ^= 0xFF  # first chunk body byte
    with pytest.raises((ChecksumError, CorruptError)):
        dmesh.sharded_decompress_framed_to_device(mesh8, bytes(bad))
