"""Production device codec: the "id" division of labour, with host-side
framing and ordered assembly.

With the native library present (every supported deployment), the
threaded C++ walk and matcher do the LZ work and the device does the
per-chunk CRC-32C:

  compress_framed:   bytes -> [B, 64Ki] batches -> device CRC (async)
                     + threaded C++ matcher/assembler -> framed stream
  decompress_framed: header scan -> C++ walk decodes each chunk into a
                     staging row -> device row slice + CRC verify ->
                     ordered assembly by chunk index

Without it, the portable jnp kernels (decode_jnp / encode_jnp) run the
whole codec on the device.

All large host buffers go through the tuned allocator (utils/hostmem);
blocks are independent, so batches can be sharded over a device mesh by
dist/ without any shared state (SURVEY.md §7.4).
"""

from __future__ import annotations

import os

import jax
import numpy as np

from snappy_tpu.utils.jaxcache import setup_compilation_cache

setup_compilation_cache()

from snappy_tpu.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    SnappyError,
    TooLargeError,
    UnsupportedError,
)
import functools

import jax.numpy as jnp

from snappy_tpu.kernels import decode_jnp, encode_jnp
from snappy_tpu.kernels.crc32c_jnp import CHUNK as _CRC_CHUNK, crc32c_chunks
from snappy_tpu.spec.format import (
    CHUNK_COMPRESSED,
    CHUNK_PADDING,
    CHUNK_STREAM_ID,
    CHUNK_UNCOMPRESSED,
    framed_chunk_type,
    MAX_BLOCK_SIZE,
    MAX_CHUNK_UNCOMPRESSED,
    MAX_UNCOMPRESSED_LEN,
    STREAM_ID_CHUNK,
    STREAM_ID_PAYLOAD,
    mask_crc,
    unmask_crc,
    max_encoded_len,
    put_uvarint,
    read_uvarint,
)
from snappy_tpu.utils.hostmem import tune_allocator

tune_allocator()

# Device batch size (64 KiB blocks per device call).  Overridable for
# tests and memory tuning.
BATCH = int(os.environ.get("SNAPPY_TPU_BATCH", "64"))
_DECODE_CMAX = 66560  # 65536 + margin, multiple of 512

# Device-side CRC-32C (GF(2)-matmul kernel): fuse checksum compute /
# verify into the device graphs so the host never touches payload bytes
# for integrity.  Disable to fall back to host CRC.
DEVICE_CRC = os.environ.get("SNAPPY_TPU_DEVICE_CRC", "1") != "0"


@functools.partial(jax.jit, static_argnames=("out_max",))
def _decode_and_crc(arr, starts, clens, dlens, want_crc, out_max: int):
    """Decode a batch and verify per-chunk CRC-32C on device; a mismatch
    surfaces as its own error code so the host can raise ChecksumError."""
    out, err = decode_jnp.decode_blocks(arr, starts, clens, dlens, out_max=out_max)
    crc = crc32c_chunks(out, dlens)
    crc_bad = (crc != want_crc) & (err == 0)
    err = jnp.where(crc_bad, jnp.int32(100), err)
    return out, err


@functools.partial(jax.jit, static_argnames=("out_max",))
def _decode_pretagged_and_crc(arr, recs, ntags, dlens, want_crc, out_max: int):
    """Hybrid path: host-validated tag records, device byte
    materialization + CRC verify (err 0 ok / 100 checksum)."""
    from snappy_tpu.kernels.decode_pretagged import decode_blocks_pretagged

    out = decode_blocks_pretagged(arr, recs, ntags, dlens, out_max=out_max)
    crc = crc32c_chunks(out, dlens)
    err = jnp.where(crc != want_crc, jnp.int32(100), jnp.int32(0))
    return out, err


# Host-side tag parsing (native C++) feeding the lighter device kernel.
# Only reached when the id path is off; the pure-device path remains
# for environments without the native lib.
HOST_PARSE = os.environ.get("SNAPPY_TPU_HOST_PARSE", "1") != "0"

_ID_ROWS = 520  # 512 image rows + 8 guard rows (wide-copy slop)


def _use_id() -> bool:
    """The id division of labour (C++ walk/matcher on the host, CRC and
    row slice on the device) needs only the native library; it runs on
    any JAX platform."""
    from snappy_tpu import native

    return native.available()


import threading as _threading

_enc_elem_tls = _threading.local()


def _enc_elem_batch(rows: int) -> np.ndarray:
    """Per-THREAD [>=rows, elem_cap] element buffer for the batched
    encode stager (every row's full host element; fallback rows read
    theirs).  Thread-local, not module-global: concurrent
    compress_framed / compress_framed_from_device calls from library
    users must not share scratch (a shared buffer silently corrupted
    emissions — r5 review finding).  Regrown if a caller needs more
    rows than the cached buffer has (tests monkeypatch BATCH) — the
    C++ side writes rows 0..B-1 at the buffer's stride, so a short
    buffer would be a heap overflow."""
    buf = getattr(_enc_elem_tls, "buf", None)
    if buf is None or buf.shape[0] < rows:
        from snappy_tpu import native

        buf = np.empty(
            (max(rows, BATCH),
             native.max_compressed_length(MAX_BLOCK_SIZE) + 8),
            np.uint8)
        _enc_elem_tls.buf = buf
    return buf


@functools.partial(jax.jit, static_argnames=())
def _decode_id_and_crc(b_u8, dlens, want_crc):
    """Id decode graph: the staged panel IS the output image — slice its
    512 image rows (one fused XLA pass) and verify per-chunk CRC-32C
    (err 0 ok / 100 checksum)."""
    nb = b_u8.shape[0]
    out = b_u8.reshape(nb, _ID_ROWS, 128)[:, :512].reshape(nb, 512 * 128)
    crc = crc32c_chunks(out, dlens)
    err = jnp.where(crc != want_crc, jnp.int32(100), jnp.int32(0))
    return out, err


# Per-chunk host ratio guard: replace any device emission that exceeds
# the reference emission (never observed across >26k fuzz inputs, but
# this makes "<= reference" unconditional).  Costs one native encode per
# chunk (~0.3ms); disable when chasing pure device-encode throughput.
RATIO_GUARD = os.environ.get("SNAPPY_TPU_RATIO_GUARD", "1") != "0"


def _crc32c_host(view) -> int:
    from snappy_tpu import native

    if native.available():
        return native.crc32c(bytes(view))
    from snappy_tpu.spec.crc32c import crc32c

    return crc32c(bytes(view))


def _oracle_block(block: bytes) -> bytes:
    from snappy_tpu import native

    if native.available():
        comp = native.compress(block)
        _, hdr = read_uvarint(comp, 0)
        return comp[hdr:]
    from snappy_tpu.spec import reference

    return reference.encode_block(block)


# ---------------------------------------------------------------------
# encode

def _encode_batches(data: bytes | memoryview, chunk_size: int,
                    needs_crc: bool = True):
    """Yield (chunk_index, chunk_len, element_bytes, crc_or_None) for
    every chunk of data, running the device encoder over padded
    batches.  crc is the raw (unmasked) CRC-32C of the uncompressed
    chunk when the engine computed it on device (id path), else None
    (the caller CRCs on host).  needs_crc=False (raw block format: no
    checksum) skips the device CRC dispatch and its fetch.

    Two-phase: dispatch every batch first (device queues are deep and
    dispatch is asynchronous), then fetch results.  jnp-engine fetches
    are trimmed to the realized compressed lengths (device-side slice
    before D2H).
    """
    data = memoryview(data)
    n = len(data)
    n_chunks = (n + chunk_size - 1) // chunk_size
    bmax = 256
    while bmax < chunk_size:
        bmax *= 2
    from snappy_tpu import native as _native

    # id path: the matcher and emission stay host-side (threaded C++,
    # the reference emission, so the ratio bound is structural), and
    # the device's job is the per-chunk CRC-32C of the UNCOMPRESSED
    # blocks.  Needs 64 KiB rows (crc32c_chunks' fixed width).
    use_enc_id = _use_id() and bmax == MAX_CHUNK_UNCOMPRESSED
    handles = []
    counts = []
    lens_all = []
    for base in range(0, n_chunks, BATCH):
        cnt = min(BATCH, n_chunks - base)
        # always dispatch full-BATCH rows: a ragged tail would compile a
        # second executable per distinct batch size
        arr = np.zeros((BATCH, bmax), dtype=np.uint8)
        lens = np.zeros(BATCH, dtype=np.int32)
        for i in range(cnt):
            off = (base + i) * chunk_size
            chunk = data[off : off + chunk_size]
            arr[i, : len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
            lens[i] = len(chunk)
        if use_enc_id:
            # dispatch the device CRC first (async), then run the host
            # matcher while the chip checksums the same blocks; no
            # dispatch at all when the caller has no use for the CRC
            # (raw streams) or opted out of device CRC
            crc_h = (crc32c_chunks(arr, lens)
                     if needs_crc and DEVICE_CRC else None)
            lens64 = lens[:cnt].astype(np.int64)
            clens64 = np.zeros(cnt, np.int64)
            hdrs64 = np.zeros(cnt, np.int64)
            rc64 = np.zeros(cnt, np.int64)
            elem_buf = _enc_elem_batch(cnt)
            bad = _native.compress_batch(
                arr[:cnt], lens64, elem_buf[:cnt], clens64, hdrs64,
                rc64, n_threads=min(4, os.cpu_count() or 1))
            if bad:  # pragma: no cover - sn_compress cannot fail here
                raise SnappyError("native compressor rejected a block")
            # materialize per-chunk blobs now: elem_buf is shared
            # across batches (this IS the final assembly work anyway)
            blobs = [
                elem_buf[i, int(hdrs64[i]):int(clens64[i])].tobytes()
                for i in range(cnt)
            ]
            handles.append(("hostenc", (crc_h, blobs, None)))
            counts.append(cnt)
            lens_all.append(lens)
            continue
        handles.append(("jnp", encode_jnp.encode_blocks(arr, lens, bmax=bmax)))
        counts.append(cnt)
        lens_all.append(lens)
    # overlap the D2H fetches: start async copies of the small
    # outputs for every batch before consuming any
    for engine, (comp, clen, ok) in handles:
        if engine == "hostenc":
            targets = (comp,) if comp is not None else ()  # CRC vector
        else:
            targets = (clen, ok)
        for h in targets:
            if hasattr(h, "copy_to_host_async"):
                h.copy_to_host_async()
    for bi, (engine, (comp, clen, ok)) in enumerate(handles):
        base = bi * BATCH
        cnt = counts[bi]
        if engine == "hostenc":
            crc_np = np.asarray(comp) if comp is not None else None
            for i, blob in enumerate(clen):  # clen slot carries blobs
                yield (base + i, int(lens_all[bi][i]), blob,
                       int(crc_np[i]) if crc_np is not None else None)
            continue
        clen_h = np.asarray(clen)[:cnt]
        ok_h = np.asarray(ok)[:cnt]
        kmax = int(clen_h.max()) if clen_h.size else 0
        kmax = min((kmax + 511) & ~511, comp.shape[1])
        comp_h = np.asarray(comp[:cnt, :kmax]) if kmax else np.zeros((cnt, 0), np.uint8)
        for i in range(cnt):
            idx = base + i
            if ok_h[i]:
                blob = comp_h[i, : int(clen_h[i])].tobytes()
            else:  # hash-collision fallback (~never)
                off = idx * chunk_size
                blob = _oracle_block(bytes(data[off : off + chunk_size]))
            if RATIO_GUARD:
                # the jnp matcher approximates the reference emission;
                # the id path's C++ matcher IS the reference emission
                off = idx * chunk_size
                ref = _oracle_block(bytes(data[off : off + chunk_size]))
                if len(ref) < len(blob):  # pragma: no cover - never observed
                    blob = ref
            yield idx, int(lens_all[bi][i]), blob, None


def compress(data: bytes) -> bytes:
    """Raw Snappy stream via the device encoder (per-64KiB fragments)."""
    if len(data) > MAX_UNCOMPRESSED_LEN:
        raise TooLargeError(len(data))
    out = bytearray(put_uvarint(len(data)))
    for _, _, blob, _crc in _encode_batches(data, MAX_BLOCK_SIZE,
                                            needs_crc=False):
        out += blob
    return bytes(out)


def compress_framed(data: bytes, chunk_size: int = MAX_CHUNK_UNCOMPRESSED) -> bytes:
    """Framed (.sz) stream via the device encoder."""
    if not 0 < chunk_size <= MAX_CHUNK_UNCOMPRESSED:
        raise ValueError(f"chunk_size must be in (0, 65536], got {chunk_size}")
    from snappy_tpu import native as _native

    if _use_id() and chunk_size == MAX_CHUNK_UNCOMPRESSED and len(data):
        return _compress_framed_id(data, _native)
    data_v = memoryview(data)
    out = bytearray(STREAM_ID_CHUNK)
    for idx, chunk_len, blob, crc in _encode_batches(data, chunk_size):
        off = idx * chunk_size
        chunk = data_v[off : off + chunk_len]
        # the id path computes the chunk CRC on device (GF(2) kernel);
        # the jnp engine leaves it to the host
        checksum = mask_crc(crc if crc is not None else _crc32c_host(chunk))
        body = put_uvarint(chunk_len) + blob
        chunk_type = framed_chunk_type(chunk_len, len(body))
        if chunk_type == CHUNK_UNCOMPRESSED:
            body = bytes(chunk)
        blen = len(body) + 4
        out += bytes((chunk_type, blen & 0xFF, (blen >> 8) & 0xFF, (blen >> 16) & 0xFF))
        out += checksum.to_bytes(4, "little")
        out += body
    return bytes(out)


def _compress_framed_id(data: bytes, _native) -> bytes:
    """Id-path framed compress of HOST bytes: per-batch the device
    CRCs the uncompressed 64 KiB chunks (dispatched
    first, async) while the threaded C++ matcher+assembler
    (sn_compress_framed_crc) emits the batch's framed records in one
    call with the device CRCs passed through — the same native
    assembly the from-device path uses, minus the D2H row fetch
    (the bytes are already host-resident).  Byte-identical to the
    generic per-chunk assembly path."""
    CS = MAX_CHUNK_UNCOMPRESSED
    data_np = np.frombuffer(data, np.uint8)
    n = len(data)
    n_chunks = -(-n // CS)
    use_dev_crc = DEVICE_CRC and CS == _CRC_CHUNK
    handles = []
    for base in range(0, n_chunks, BATCH):
        cnt = min(BATCH, n_chunks - base)
        lo = base * CS
        hi = min(n, lo + cnt * CS)
        crc_k = None
        if use_dev_crc:
            if cnt == BATCH and hi - lo == cnt * CS:
                # full batch of full rows: zero-copy reshape view of
                # the input — safe to alias under device_put (the
                # source bytes object is immutable and outlives the
                # transfer)
                blocks = data_np[lo:hi].reshape(cnt, CS)
                lens_k = np.full(cnt, CS, np.int32)
            else:
                # always dispatch full-BATCH rows: a ragged tail
                # would compile a second executable per distinct
                # tail size (same rule as _encode_batches)
                blocks = np.zeros((BATCH, CS), np.uint8)
                blocks.reshape(-1)[: hi - lo] = data_np[lo:hi]
                lens_k = np.zeros(BATCH, np.int32)
                lens_k[:cnt] = np.minimum(
                    hi - lo - np.arange(cnt, dtype=np.int64) * CS, CS)
            # keep the full-BATCH vector on device (a [:cnt] slice
            # would compile per distinct tail size); trim on host
            crc_k = crc32c_chunks(
                jax.device_put(blocks), jnp.asarray(lens_k))
        handles.append((lo, hi - lo, crc_k))
    crc_all = None
    if use_dev_crc:
        # ONE concatenated fetch instead of one per batch
        crc_all = jnp.concatenate([c for _lo, _nb, c in handles])
        if hasattr(crc_all, "copy_to_host_async"):
            crc_all.copy_to_host_async()
    crc_np = np.asarray(crc_all) if crc_all is not None else None
    out = bytearray(STREAM_ID_CHUNK)
    nt = min(4, os.cpu_count() or 1)
    for k, (lo, nb, _c) in enumerate(handles):
        cnt = -(-nb // CS)
        # each batch contributed a full-BATCH CRC vector; trim here
        crcs = (crc_np[k * BATCH:k * BATCH + cnt]
                if crc_np is not None else None)
        out += _native.compress_framed_crc(
            data_np[lo:lo + nb], nb, crcs, chunk_size=CS,
            threads=nt, write_id=False)
    return bytes(out)


# ---------------------------------------------------------------------
# decode

def _scan_frames(src: bytes):
    """Parse framed chunk headers.  Returns list of
    (type, payload_off, payload_len, crc, dst_len, elem_start) and the
    total output size.  elem_start is the element offset inside the
    payload for compressed chunks (varint header length)."""
    n = len(src)
    if n < len(STREAM_ID_CHUNK) or src[: len(STREAM_ID_CHUNK)] != STREAM_ID_CHUNK:
        raise BadMagicError()
    chunks = []
    pos = len(STREAM_ID_CHUNK)
    total = 0
    while pos < n:
        if n - pos < 4:
            raise CorruptError("truncated chunk header")
        ctype = src[pos]
        body = src[pos + 1] | (src[pos + 2] << 8) | (src[pos + 3] << 16)
        pos += 4
        if n - pos < body:
            raise CorruptError("truncated chunk body")
        if ctype == CHUNK_STREAM_ID:
            if src[pos : pos + body] != STREAM_ID_PAYLOAD:
                raise BadMagicError()
            pos += body
            continue
        if ctype == CHUNK_PADDING or 0x80 <= ctype <= 0xFD:
            pos += body
            continue
        if 0x02 <= ctype <= 0x7F:
            raise UnsupportedError(ctype)
        if body < 4:
            raise CorruptError("chunk body shorter than checksum")
        crc = int.from_bytes(src[pos : pos + 4], "little")
        p_off, p_len = pos + 4, body - 4
        if ctype == CHUNK_COMPRESSED:
            dst_len, hdr = read_uvarint(src, p_off)
            if dst_len > MAX_CHUNK_UNCOMPRESSED:
                raise CorruptError("chunk decodes to more than 64KiB")
            chunks.append((ctype, p_off, p_len, crc, dst_len, hdr))
        else:
            if p_len > MAX_CHUNK_UNCOMPRESSED:
                raise CorruptError("uncompressed chunk larger than 64KiB")
            chunks.append((ctype, p_off, p_len, crc, p_len, 0))
        total += chunks[-1][4]
        pos += body
    return chunks, total


def _host_decompress_raw(payload: bytes) -> bytes:
    """Host decode of one raw snappy stream (varint preamble + elements)."""
    from snappy_tpu import native

    if native.available():
        return native.decompress(payload)
    from snappy_tpu.kernels import decode_np

    return decode_np.decompress(payload)


def decompress_framed(data: bytes, verify_checksums: bool = True) -> bytes:
    chunks, total = _scan_frames(data)
    out = np.empty(max(1, total), dtype=np.uint8)
    src_arr = np.frombuffer(data, dtype=np.uint8)

    # output offsets: exclusive scan over chunk sizes, original order
    dst_offs = []
    acc = 0
    for ch in chunks:
        dst_offs.append(acc)
        acc += ch[4]

    decode_chunk_range(
        src_arr, chunks, dst_offs, out, range(len(chunks)), verify_checksums
    )
    return out[:total].tobytes()


def decode_chunk_range(src_arr, chunks, dst_offs, out, subset,
                       verify_checksums: bool = True) -> None:
    """Decode the chunk-index `subset` of a scanned frame index into
    `out` at per-chunk offsets `dst_offs` (indexed by chunk index; the
    caller may shift them for a host-local buffer).  This is the seam
    the multi-host layer shares with single-host decompress_framed:
    chunk independence makes the split structural (SURVEY.md §7.4)."""
    subset = list(subset)
    all_comp = [i for i in subset if chunks[i][0] == CHUNK_COMPRESSED]
    # The format allows payloads up to ~2x the decoded size (1-byte
    # literals are 2 bytes each); payloads beyond the device row width
    # are valid but rare — decode those on host instead of raising.
    host_idx = {i for i in all_comp if chunks[i][2] > _DECODE_CMAX}
    comp_idx = [i for i in all_comp if i not in host_idx]
    for i in sorted(host_idx):
        _, p_off, p_len, crc, dst_len, hdr = chunks[i]
        blob = _host_decompress_raw(bytes(src_arr[p_off : p_off + p_len]))
        if len(blob) != dst_len:
            raise CorruptError("chunk preamble disagrees with decoded size")
        out[dst_offs[i] : dst_offs[i] + dst_len] = np.frombuffer(blob, dtype=np.uint8)
    # uncompressed chunks: straight copies
    for i in subset:
        ch = chunks[i]
        if ch[0] == CHUNK_UNCOMPRESSED:
            out[dst_offs[i] : dst_offs[i] + ch[4]] = src_arr[ch[1] : ch[1] + ch[2]]

    if comp_idx:
        # two-phase: dispatch every batch, then fetch (device queues
        # are deep; the fetches overlap below)
        use_dev_crc = (
            verify_checksums and DEVICE_CRC and MAX_CHUNK_UNCOMPRESSED == _CRC_CHUNK
        )
        from snappy_tpu import native as _native

        use_host_parse = HOST_PARSE and use_dev_crc and _native.available()
        # production engine: the id walk (host C++ stage + device row
        # slice + fused device CRC); one portable path (jnp)
        use_id = use_dev_crc and _use_id()
        # Max elements per chunk: every element is >= 2 payload bytes
        # (1-byte-literal tag+data, or a 1-byte-offset copy), so a
        # p_len <= _DECODE_CMAX payload holds at most _DECODE_CMAX//2
        # elements; +2 slack.  Guarantees sn_parse_tags never sees a
        # too-small record buffer on a valid stream.
        _T_CAP = _DECODE_CMAX // 2 + 2
        handles = []
        for base in range(0, len(comp_idx), BATCH):
            grp = comp_idx[base : base + BATCH]
            # bucket the compressed-row width to the batch's needs: the
            # decoder's tag machinery scales with CMAX, and compressible
            # chunks are typically 2-5x smaller than the worst case
            batch_kmax = max((chunks[i][2] for i in grp), default=0)
            cmax = _DECODE_CMAX
            for bucket in (16640, 33280):
                if batch_kmax <= bucket:
                    cmax = bucket
                    break
            dlens = np.zeros(BATCH, dtype=np.int32)
            want = np.zeros(BATCH, dtype=np.uint32)
            for row, i in enumerate(grp):
                _, p_off, p_len, crc, dst_len, hdr = chunks[i]
                if p_len > cmax:
                    raise CorruptError("compressed chunk implausibly large")
                dlens[row] = dst_len
                want[row] = unmask_crc(crc)
            if not use_id:
                # the id walk reads payloads from src_arr directly;
                # only the jnp/hybrid paths need the padded copy
                arr = np.zeros((BATCH, cmax), dtype=np.uint8)
                starts = np.zeros(BATCH, dtype=np.int32)
                clens = np.zeros(BATCH, dtype=np.int32)
                for row, i in enumerate(grp):
                    _, p_off, p_len, _crc, _dst_len, hdr = chunks[i]
                    arr[row, :p_len] = src_arr[p_off : p_off + p_len]
                    starts[row] = hdr
                    clens[row] = p_len
            if use_id:
                # host walk decodes each chunk straight into its
                # staging row; device = row slice + CRC.  Id staging
                # has no caps, so the only negative rc is a corrupt
                # stream.
                ng = len(grp)
                b_u8 = np.empty((BATCH, _ID_ROWS * 128), dtype=np.uint8)
                offs64 = np.array([chunks[i][1] for i in grp], np.int64)
                lens64 = np.array([chunks[i][2] for i in grp], np.int64)
                hdrs64 = np.array([chunks[i][5] for i in grp], np.int64)
                dstl64 = np.array([chunks[i][4] for i in grp], np.int64)
                rc64 = np.zeros(ng, np.int64)
                bad = _native.stage_flat_dec_id_batch(
                    src_arr, offs64, lens64, hdrs64, dstl64, _ID_ROWS,
                    b_u8[:ng], rc64,
                    n_threads=min(4, os.cpu_count() or 1))
                if bad:
                    raise CorruptError("invalid chunk payload (id stage)")
                handles.append(_decode_id_and_crc(b_u8, dlens, want))
            elif use_host_parse:
                # hybrid: validate + tag-parse on host (native C++),
                # device does only the per-byte materialization + CRC
                tmp = np.empty((_T_CAP, 4), dtype=np.int32)
                parsed = []
                t_batch = 1
                for row, i in enumerate(grp):
                    _, p_off, p_len, crc, dst_len, hdr = chunks[i]
                    nt = _native.parse_tags(
                        src_arr[p_off : p_off + p_len].tobytes(), hdr, dst_len, tmp
                    )
                    parsed.append(np.array(tmp[:nt]))
                    t_batch = max(t_batch, nt)
                t_cap = 2048
                while t_cap < t_batch:
                    t_cap *= 2
                t_cap = min(t_cap, _T_CAP)
                recs = np.zeros((BATCH, t_cap, 4), dtype=np.int32)
                ntags = np.zeros(BATCH, dtype=np.int32)
                for row, p in enumerate(parsed):
                    recs[row, : len(p)] = p
                    ntags[row] = len(p)
                handles.append(_decode_pretagged_and_crc(
                    arr, recs, ntags, dlens, want,
                    out_max=MAX_CHUNK_UNCOMPRESSED))
            elif use_dev_crc:
                handles.append(_decode_and_crc(
                    arr, starts, clens, dlens, want,
                    out_max=MAX_CHUNK_UNCOMPRESSED))
            else:
                handles.append(decode_jnp.decode_blocks(
                    arr, starts, clens, dlens,
                    out_max=MAX_CHUNK_UNCOMPRESSED))
        for res, err in handles:  # overlap the D2H fetches
            for h in (res, err):
                if hasattr(h, "copy_to_host_async"):
                    h.copy_to_host_async()
        for bi, (res, err) in enumerate(handles):
            grp = comp_idx[bi * BATCH : (bi + 1) * BATCH]
            err_h = np.asarray(err)
            res_h = np.asarray(res)
            for row, i in enumerate(grp):
                code = int(err_h[row])
                if code == 100:
                    raise ChecksumError(chunks[i][3], None)
                if code != decode_jnp.ERR_NONE:
                    raise CorruptError(
                        decode_jnp.ERR_MESSAGES.get(code, "decode error")
                    )
                d = chunks[i][4]
                out[dst_offs[i] : dst_offs[i] + d] = res_h[row, :d]

    if verify_checksums:
        dev_checked = DEVICE_CRC and MAX_CHUNK_UNCOMPRESSED == _CRC_CHUNK
        for i in subset:
            ch = chunks[i]
            if (dev_checked and ch[0] == CHUNK_COMPRESSED
                    and i not in host_idx):
                continue  # verified on device with the decode
            got = mask_crc(_crc32c_host(out[dst_offs[i] : dst_offs[i] + ch[4]]))
            if got != ch[3]:
                raise ChecksumError(ch[3], got)


# Segment width of the raw id stager: copies reach <= 64 KiB back, so
# the host walk keeps a rolling 64 KiB carry between segments.
_RAW_SEG = 65536


def decompress(data: bytes) -> bytes:
    """Raw Snappy stream decode (host-memory destination).

    The host walk IS the decode (docs/architecture.md): a raw stream
    has no CRC for the device to verify, so with a host-bytes
    destination the device can add nothing but a round trip; the
    native walk decodes raw streams of any size.  Decode with a DEVICE
    destination (the data-loader case) is decompress_to_device.  The
    jnp kernel remains the no-native portable path."""
    dst_len, hdr = read_uvarint(data, 0)
    from snappy_tpu import native

    if native.available():
        return native.decompress(data)
    return decode_jnp.decode_block_jnp(data, dst_len, start=hdr)


def decompress_to_device(data: bytes) -> "jax.Array":
    """Raw Snappy stream decode to a DEVICE-RESIDENT uint8 array.

    The decode-to-device data-loader path (id): the host walk decodes
    64 KiB segments straight into staging rows (resume state carries
    straddling tags, a rolling 64 KiB history carries copy sources),
    H2D carries exactly the decompressed bytes, and the payload never
    crosses back to the host.  Falls back to host decode + device_put
    without the native library, or on streams with format-legal
    >64 KiB copy offsets (no real encoder emits them)."""
    dst_len, hdr = read_uvarint(data, 0)
    from snappy_tpu import native as _native

    if not (_use_id() and dst_len > 0):
        return jax.device_put(
            np.frombuffer(decompress(data), np.uint8))
    arr = np.frombuffer(data, np.uint8)
    rb_id = 512  # pure output rows: no guard/slop, the device only slices
    nseg = (dst_len + _RAW_SEG - 1) // _RAW_SEG
    W = min(BATCH, nseg)
    state = np.array([hdr, 0, 0, 0, 0, 0], np.int64)
    img = np.zeros(65536 + _RAW_SEG + 64, np.uint8)
    # one staging buffer, copied per batch before device_put:
    # device_put zero-copy ALIASES host numpy buffers (alignment-
    # dependent), so handing it a reused buffer corrupts earlier
    # batches' device arrays once the stream outgrows the buffer pool
    # (reproduced at 20 MiB).  The copy is the
    # fix, not more buffers: nothing bounds how late the backend
    # materializes a transfer.
    b_u8 = np.empty((W, rb_id * 128), np.uint8)
    outs = []
    done = 0
    while done < dst_len:
        cnt = 0
        while cnt < W and done < dst_len:
            seg = min(_RAW_SEG, dst_len - done)
            ok = _native.stage_flat_dec_id_seg(
                arr, dst_len, state, img, seg, rb_id, b_u8[cnt])
            if not ok:  # >64 KiB offset: host decoder instead
                return jax.device_put(
                    np.frombuffer(decompress(data), np.uint8))
            # slide the carry: last 64 KiB of (carry + this segment)
            img[:65536] = img[seg:seg + 65536].copy()
            done += seg
            cnt += 1
        outs.append(jax.device_put(b_u8[:cnt].copy()))
    if int(state[0]) != len(data) or state[3] or state[5]:
        raise CorruptError("raw stream length disagrees with preamble")
    return jnp.concatenate([o.reshape(-1) for o in outs])[:dst_len]


@jax.jit
def _pad_to_rows(arr_flat):
    """Zero-pad a flat uint8 device array to 64 KiB chunk rows (one
    fused XLA pass; the pad bytes are CRC-exempt via the lens mask)."""
    n = arr_flat.shape[0]
    n_chunks = max(1, -(-n // MAX_CHUNK_UNCOMPRESSED))
    return jnp.pad(
        arr_flat, (0, n_chunks * MAX_CHUNK_UNCOMPRESSED - n)
    ).reshape(n_chunks, MAX_CHUNK_UNCOMPRESSED)


def compress_framed_from_device(arr) -> bytes:
    """Compress a DEVICE-RESIDENT uint8 array into a framed .sz stream.

    The encode half of the data-loader story (the decode half is
    decompress_framed_to_device): an array already in device memory —
    a checkpoint shard, a generated batch — becomes framed bytes with
    its per-chunk CRC-32C computed on the device before any byte
    leaves it.  Division of labour mirrors the id path: the device
    graph pads + rows the array and checksums every 64 KiB
    chunk (dispatched first, async); the D2H row fetch overlaps the
    threaded C++ matcher that emits each chunk's element; assembly is
    chunk-ordered on host.  The framed output is byte-identical to
    compress_framed(bytes(arr)) on the id path — same matcher, same
    CRCs — so the ratio bound stays structural.

    Recompiles per distinct input length (XLA static shapes) — the
    data-loader pattern of fixed array shapes amortizes this.  Falls
    back to fetching the whole array + compress_framed when the native
    matcher is unavailable.  Reference analog: the container layer's
    Create/Build direction (clickdeb/deb.go:348-406), here with the
    chip holding the payload."""
    import jax as _jax

    if arr.dtype != jnp.uint8:
        raise ValueError(f"expected uint8 array, got {arr.dtype}")
    arr = arr.reshape(-1)
    n = int(arr.shape[0])
    if n == 0:
        return bytes(STREAM_ID_CHUNK)
    from snappy_tpu import native as _native

    if not _native.available():
        return compress_framed(bytes(np.asarray(arr)))
    CS = MAX_CHUNK_UNCOMPRESSED
    n_chunks = -(-n // CS)
    lens_np = np.minimum(
        n - np.arange(n_chunks, dtype=np.int64) * CS, CS)
    rows = _pad_to_rows(arr)
    use_dev_crc = DEVICE_CRC and CS == _CRC_CHUNK
    # dispatch every batch's device work first (CRC + the row slice
    # the fetch will drain); the device queues are deep
    handles = []
    for base in range(0, n_chunks, BATCH):
        cnt = min(BATCH, n_chunks - base)
        rows_k = rows[base:base + cnt]
        crc_k = None
        if use_dev_crc:
            crc_k = crc32c_chunks(
                rows_k, jnp.asarray(lens_np[base:base + cnt]
                                    .astype(np.int32)))
        handles.append((rows_k, crc_k, lens_np[base:base + cnt]))
    # ONE concatenated CRC fetch for the whole stream; row drains
    # still overlap per batch
    crc_all = None
    if use_dev_crc:
        crc_all = jnp.concatenate([c for _r, c, _l in handles])
    for rows_k, _c, _l in handles:  # overlap the D2H drains
        for h in (rows_k, crc_all):
            if h is not None and hasattr(h, "copy_to_host_async"):
                h.copy_to_host_async()
    crc_np = np.asarray(crc_all) if crc_all is not None else None
    out = bytearray(STREAM_ID_CHUNK)
    nt = min(4, os.cpu_count() or 1)
    done = 0
    for rows_k, _c, lens_k in handles:
        # The fetched (cnt, 64Ki) row matrix IS the contiguous chunk
        # byte stream (every chunk but the global last is full), so
        # the whole batch — matcher, incompressible fallback, header
        # + CRC framing, ordered assembly — is ONE threaded C++ call;
        # device CRCs (raw) are passed through and masked natively.
        blocks = np.asarray(rows_k)
        cnt = len(lens_k)
        crcs = (crc_np[done:done + cnt]
                if crc_np is not None else None)
        done += cnt
        out += _native.compress_framed_crc(
            blocks, int(lens_k.sum()), crcs, chunk_size=CS,
            threads=nt, write_id=False)
    return bytes(out)


def compress_from_device(arr) -> bytes:
    """RAW-format counterpart of compress_framed_from_device.  The raw
    block format has no checksums (spec §8.1), so there is no device
    CRC to fuse — the chip's only contribution would be the D2H fetch
    itself.  Documented division of labour: fetch the array once,
    then the threaded host encoder (the same interleaved matcher the
    framed path uses) emits the stream.  Byte-identical to
    compress(bytes(arr)) under the production (native) engine; exists
    so the to/from-device API matrix is complete in both formats."""
    if arr.dtype != jnp.uint8:
        raise ValueError(f"expected uint8 array, got {arr.dtype}")
    arr = arr.reshape(-1)
    from snappy_tpu import native as _native

    host = np.asarray(arr)
    if _native.available():
        return _native.compress(host.tobytes())
    return compress(host.tobytes())


def stage_id_rows(src_arr: np.ndarray, grp, b_u8: np.ndarray,
                  dlens: np.ndarray, want: np.ndarray) -> None:
    """Id-stage one group of scanned framed chunks into staging rows
    (shared by the single-chip and mesh-sharded to-device decoders):
    compressed chunks decode via the threaded C++ id walk in contiguous
    runs, uncompressed chunks ARE their payload; dlens/want are filled
    per row (rows past len(grp) are left as the caller initialized
    them).  Raises CorruptError on an invalid payload.  Without the
    native library the rows decode through the host np decoder instead
    of raising (same contract, slower) — the dist entry points degrade
    like the single-chip path does."""
    from snappy_tpu import native as _native

    comp_rows = []
    for row, ch in enumerate(grp):
        dlens[row] = ch[4]
        want[row] = unmask_crc(ch[3])
        if ch[0] == CHUNK_COMPRESSED:
            comp_rows.append(row)
        else:  # uncompressed: the row IS the payload
            _t, p_off, p_len, _c, _d, _h = ch
            b_u8[row, :p_len] = src_arr[p_off:p_off + p_len]
            b_u8[row, p_len:] = 0
    if not _native.available():
        for row in comp_rows:
            _t, p_off, p_len, _c, dst_len, _h = grp[row]
            blob = _host_decompress_raw(
                bytes(src_arr[p_off:p_off + p_len]))
            if len(blob) != dst_len:
                raise CorruptError(
                    "chunk preamble disagrees with decoded size")
            b_u8[row, :dst_len] = np.frombuffer(blob, np.uint8)
            b_u8[row, dst_len:] = 0
        return
    r = 0
    while r < len(comp_rows):
        r2 = r
        while (r2 + 1 < len(comp_rows)
               and comp_rows[r2 + 1] == comp_rows[r2] + 1):
            r2 += 1
        rows = comp_rows[r:r2 + 1]
        offs64 = np.array([grp[i][1] for i in rows], np.int64)
        lens64 = np.array([grp[i][2] for i in rows], np.int64)
        hdrs64 = np.array([grp[i][5] for i in rows], np.int64)
        dstl64 = np.array([grp[i][4] for i in rows], np.int64)
        rc64 = np.zeros(len(rows), np.int64)
        bad = _native.stage_flat_dec_id_batch(
            src_arr, offs64, lens64, hdrs64, dstl64, b_u8.shape[1] // 128,
            b_u8[rows[0]:rows[0] + len(rows)], rc64,
            n_threads=min(4, os.cpu_count() or 1))
        if bad:
            raise CorruptError("invalid chunk payload (id stage)")
        r = r2 + 1


def decompress_framed_to_device(
        data: bytes, verify_checksums: bool = True) -> "jax.Array":
    """Framed-stream decode to a DEVICE-RESIDENT uint8 array.

    The decode-to-device data-loader path (id): the host id-stages
    each chunk (threaded C++ walk), H2D carries exactly the
    decompressed bytes, per-chunk CRC-32C is verified on the device
    where the bytes land, and only the tiny err vector crosses back.
    Device assembly is a reshape + slice, valid because every chunk
    but the last fills a 64 KiB row (the framed writer's layout);
    ragged streams, and runs without the native library, fall back to
    the host path + device_put."""
    chunks, total = _scan_frames(data)
    use_id = (_use_id() and DEVICE_CRC
              and MAX_CHUNK_UNCOMPRESSED == _CRC_CHUNK)
    uniform = total > 0 and all(
        ch[4] == _CRC_CHUNK for ch in chunks[:-1]) and all(
        ch[2] <= _DECODE_CMAX for ch in chunks
        if ch[0] == CHUNK_COMPRESSED)
    if not (use_id and uniform):
        return jax.device_put(np.frombuffer(
            decompress_framed(data, verify_checksums), np.uint8))
    src_arr = np.frombuffer(data, np.uint8)
    parts = []
    for base in range(0, len(chunks), BATCH):
        grp = chunks[base:base + BATCH]
        dlens = np.zeros(BATCH, np.int32)
        want = np.zeros(BATCH, np.uint32)
        b_u8 = np.empty((BATCH, _ID_ROWS * 128), np.uint8)
        stage_id_rows(src_arr, grp, b_u8, dlens, want)
        parts.append((grp, _decode_id_and_crc(b_u8, dlens, want)))
    if verify_checksums:
        for grp, (_res, err) in parts:  # tiny D2H; payload stays put
            err_h = np.asarray(err)
            for row, ch in enumerate(grp):
                if int(err_h[row]) == 100:
                    raise ChecksumError(ch[3], None)
    # _decode_id_and_crc rows are already the sliced 64 KiB images
    body = jnp.concatenate(
        [res for _grp, (res, _e) in parts]).reshape(-1)
    return body[:total]
