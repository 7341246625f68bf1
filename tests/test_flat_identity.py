"""The "id" engine: identity staging + device slice/CRC.

The host walk decodes each chunk directly into the staging panel
(sn_stage_flat_dec_id*); the device graph slices the 512 image rows
and verifies CRC-32C.  Encode-side, the matcher/emission stay
host-side (sn_compress_batch) and the device CRCs the uncompressed
blocks.  See docs/architecture.md for why this is the production path.
"""

import numpy as np
import pytest

from snappy_tpu import native
from snappy_tpu.bench.corpus import make_corpus
from snappy_tpu.errors import ChecksumError, CorruptError
from snappy_tpu.spec import framing
from snappy_tpu.spec.format import read_uvarint

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)

ID_ROWS = 520


@pytest.fixture()
def corpus():
    return b"".join(d for _, d in make_corpus(1 << 20, seed=41))


class TestIdStager:
    def test_decodes_into_panel_and_zeroes_tail(self, corpus):
        for n in (65536, 65000, 1000, 1):
            blk = corpus[:n]
            c = native.compress(blk)
            dlen, h = read_uvarint(c, 0)
            b_row = np.full(ID_ROWS * 128, 0xAA, np.uint8)
            native.stage_flat_dec_id(
                np.frombuffer(c, np.uint8), h, dlen, ID_ROWS, b_row)
            assert b_row[:dlen].tobytes() == blk
            assert not b_row[dlen:].any(), "tail/guard must be zeroed"

    def test_batch_parity_and_threads(self, corpus):
        blks = [corpus[i * 65536:(i + 1) * 65536] for i in range(8)]
        elems = [np.frombuffer(native.compress(b), np.uint8) for b in blks]
        offs = np.zeros(8, np.int64)
        lens = np.zeros(8, np.int64)
        pos = 0
        for i, e in enumerate(elems):
            offs[i], lens[i] = pos, len(e)
            pos += len(e)
        ecat = np.concatenate(elems)
        hdrs = np.array([read_uvarint(e.tobytes(), 0)[1] for e in elems],
                        np.int64)
        dstl = np.array([len(b) for b in blks], np.int64)
        rc = np.zeros(8, np.int64)
        rows = np.empty((8, ID_ROWS * 128), np.uint8)
        bad = native.stage_flat_dec_id_batch(
            ecat, offs, lens, hdrs, dstl, ID_ROWS, rows, rc, n_threads=3)
        assert bad == 0 and (rc == 0).all()
        for i, b in enumerate(blks):
            assert rows[i, :len(b)].tobytes() == b

    def test_corrupt_raises(self, corpus):
        c = native.compress(corpus[:30000])
        dlen, h = read_uvarint(c, 0)
        b_row = np.empty(ID_ROWS * 128, np.uint8)
        with pytest.raises(CorruptError):
            native.stage_flat_dec_id(
                np.frombuffer(c[:-4], np.uint8), h, dlen, ID_ROWS, b_row)

    def test_rb_too_small_rejected(self, corpus):
        c = native.compress(corpus[:65536])
        dlen, h = read_uvarint(c, 0)
        b_row = np.empty(ID_ROWS * 128, np.uint8)
        with pytest.raises(Exception):
            native.stage_flat_dec_id(
                np.frombuffer(c, np.uint8), h, dlen, 512, b_row)


class TestCompressBatch:
    def test_rows_match_single_compress(self, corpus):
        blks = [corpus[i * 50000:(i + 1) * 50000] for i in range(4)]
        arr = np.zeros((4, 65536), np.uint8)
        lens = np.zeros(4, np.int64)
        for i, b in enumerate(blks):
            arr[i, :len(b)] = np.frombuffer(b, np.uint8)
            lens[i] = len(b)
        cap = native.max_compressed_length(65536) + 8
        elem = np.empty((4, cap), np.uint8)
        cl = np.zeros(4, np.int64)
        hd = np.zeros(4, np.int64)
        rc = np.zeros(4, np.int64)
        bad = native.compress_batch(arr, lens, elem, cl, hd, rc,
                                    n_threads=2)
        assert bad == 0
        for i, b in enumerate(blks):
            want = native.compress(b)
            assert elem[i, :cl[i]].tobytes() == want
            _, h = read_uvarint(want, 0)
            assert hd[i] == h


class TestIdRuntime:
    @pytest.fixture(autouse=True)
    def _force_flat(self):
        from snappy_tpu.runtime import device_codec

        self.dc = device_codec

    def test_framed_roundtrip_and_mode_parity(self, corpus, monkeypatch):
        sz = self.dc.compress_framed(corpus)
        assert self.dc.decompress_framed(sz) == corpus
        assert framing.decompress_framed(sz) == corpus
        # the generic per-chunk path (no native) must round-trip too
        monkeypatch.setattr(self.dc, "_use_id", lambda: False)
        part = corpus[:70_000]
        assert framing.decompress_framed(self.dc.compress_framed(part)) == part

    def test_decode_selects_id_graph(self, corpus, monkeypatch):
        calls = []
        real = self.dc._decode_id_and_crc

        def spy(*a, **k):
            calls.append(1)
            return real(*a, **k)

        monkeypatch.setattr(self.dc, "_decode_id_and_crc", spy)
        sz = self.dc.compress_framed(corpus[:200_000])
        assert self.dc.decompress_framed(sz) == corpus[:200_000]
        assert calls, "id mode must dispatch the identity decode graph"

    def test_checksum_error_on_payload_corruption(self, corpus):
        sz = bytearray(self.dc.compress_framed(corpus[:130_000]))
        # flip one payload byte past the first chunk's header+crc
        sz[80] ^= 0xFF
        with pytest.raises((ChecksumError, CorruptError)):
            self.dc.decompress_framed(bytes(sz))

    def test_encode_device_crc_matches_host(self, corpus, monkeypatch):
        """The framed stream's chunk CRCs (device-computed on the id path)
        must equal the host-CRC'd reference framing bit-for-bit."""
        data = corpus[:300_000]
        sz = self.dc.compress_framed(data)
        ref = framing.compress_framed(data)
        assert sz == ref

    def test_mixed_uncompressed_chunks(self):
        rng = np.random.default_rng(7)
        data = rng.bytes(200_000)  # incompressible -> uncompressed chunks
        sz = self.dc.compress_framed(data)
        assert self.dc.decompress_framed(sz) == data
        assert framing.decompress_framed(sz) == data
