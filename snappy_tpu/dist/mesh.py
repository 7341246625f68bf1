"""Mesh construction + sharded batch codec (single-host multi-chip, and
the multi-host entry points).

Design (SURVEY.md §7.4, BASELINE configs 4-5):
  - 1-D mesh over chips ('d'); multi-host adds a 'host' dimension only
    conceptually - jax.distributed gives every process the global mesh.
  - Blocks shard over 'd' on the batch dimension via NamedSharding; the
    kernels are pure vmapped element-wise/gather pipelines, so XLA's
    SPMD partitioner runs them with zero communication.
  - Per-block compressed lengths return to the host (tiny transfer);
    output assembly is an ordered gather keyed by block index - never
    by device/collective ordering.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from snappy_tpu.kernels import decode_jnp, encode_jnp
from snappy_tpu.utils.jaxcache import setup_compilation_cache

setup_compilation_cache()

__all__ = [
    "make_mesh",
    "init_distributed",
    "sharded_encode",
    "sharded_decode",
    "sharded_decode_id",
    "sharded_decompress_framed_to_device",
    "sharded_compress_framed_from_device",
    "sharded_encode_rows_to_chunks",
    "sharded_crc",
    "stage_dec_id_batch",
    "roundtrip_step",
]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), ("d",))


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host runtime init (BASELINE config 5).  Call once per host
    process before building the mesh; jax.distributed wires DCN and
    makes jax.devices() global."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def _pad_to_mesh(mesh: Mesh, *arrays):
    """Pad the batch axis to a multiple of the mesh size (padding rows are
    zero-length blocks, which the kernels treat as empty)."""
    n = mesh.devices.size
    b = arrays[0].shape[0]
    rem = (-b) % n
    if rem == 0:
        return arrays, b
    padded = tuple(
        np.concatenate([a, np.zeros((rem,) + a.shape[1:], a.dtype)]) for a in arrays
    )
    return padded, b


def _shard_batch(mesh: Mesh, *arrays):
    sharding = NamedSharding(mesh, P("d"))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def sharded_encode(mesh: Mesh, blocks: np.ndarray, lens: np.ndarray, bmax: int):
    """Encode a [B, bmax] batch sharded over the mesh (auto-padded to a
    multiple of the mesh size).  Returns host numpy (comp, comp_len, ok)."""
    (blocks, lens), b = _pad_to_mesh(mesh, blocks, lens)
    blocks_d, lens_d = _shard_batch(mesh, blocks, lens)
    with mesh:
        comp, clen, ok = encode_jnp.encode_blocks(blocks_d, lens_d, bmax=bmax)
    return np.asarray(comp)[:b], np.asarray(clen)[:b], np.asarray(ok)[:b]


def sharded_decode(
    mesh: Mesh,
    comp: np.ndarray,
    start: np.ndarray,
    comp_len: np.ndarray,
    dst_len: np.ndarray,
    out_max: int,
):
    """Decode a padded compressed batch sharded over the mesh."""
    (comp, start, comp_len, dst_len), b = _pad_to_mesh(
        mesh, comp, start, comp_len, dst_len
    )
    comp_d, start_d, clen_d, dlen_d = _shard_batch(mesh, comp, start, comp_len, dst_len)
    with mesh:
        out, err = decode_jnp.decode_blocks(
            comp_d, start_d, clen_d, dlen_d, out_max=out_max
        )
    return np.asarray(out)[:b], np.asarray(err)[:b]


_ID_ROWS = 520  # id staging panel (512 image rows + slop guard)


def stage_dec_id_batch(elems: list[bytes]):
    """Host half of the id path for a block batch: each element is
    validated + decoded straight into its staging row
    (native.stage_flat_dec_id).  Returns (b_u8, dst_lens, want_crc);
    in production the expected CRC rides the chunk header — here it is
    computed from the staged image for the dry-run assertion."""
    from snappy_tpu import native
    from snappy_tpu.spec.format import read_uvarint

    B = len(elems)
    b_u8 = np.zeros((B, _ID_ROWS * 128), np.uint8)
    dst_lens = np.zeros(B, np.int32)
    want = np.zeros(B, np.uint32)
    for i, e in enumerate(elems):
        dlen, hdr = read_uvarint(e, 0)
        native.stage_flat_dec_id(
            np.frombuffer(e, np.uint8), hdr, dlen, _ID_ROWS, b_u8[i])
        dst_lens[i] = dlen
        want[i] = native.crc32c_arr(b_u8[i, :dlen])
    return b_u8, dst_lens, want


def sharded_decode_id(
    mesh: Mesh,
    b_u8: np.ndarray,
    dst_lens: np.ndarray,
    want_crc: np.ndarray,
):
    """PRODUCTION id decode data-parallel over the mesh: each device
    slices its staged rows' 512-row output image and verifies
    per-chunk CRC-32C — zero collectives (chunk
    independence, SURVEY.md §7.4).  Padding rows carry dst_len 0 and
    are CRC-exempt.  Returns host (out[B, 65536], err[B]) where err
    100 = device CRC mismatch."""
    from snappy_tpu.kernels.crc32c_jnp import crc32c_chunks

    (b_u8, dst_lens, want_crc), b = _pad_to_mesh(
        mesh, b_u8, dst_lens, want_crc
    )
    arrs = _shard_batch(mesh, b_u8, dst_lens, want_crc)

    def _local(rows, dlens, want):
        nb = rows.shape[0]
        out = rows.reshape(nb, _ID_ROWS, 128)[:, :512].reshape(
            nb, 512 * 128)
        crc = crc32c_chunks(out, dlens)
        err = jnp.where((crc != want) & (dlens > 0), jnp.int32(100),
                        jnp.int32(0))
        return out, err

    with mesh:
        out, err = jax.jit(jax.shard_map(
            _local, mesh=mesh,
            in_specs=(P("d"), P("d"), P("d")),
            out_specs=(P("d"), P("d")),
        ))(*arrs)
    return np.asarray(out)[:b], np.asarray(err)[:b]


def sharded_decompress_framed_to_device(
    mesh: Mesh, data: bytes, verify_checksums: bool = True,
    chunk_range: tuple[int, int] | None = None,
):
    """Stream-level DATA-LOADER entry (id path over the mesh): scan a
    framed stream, id-stage every chunk on host (threaded C++ walk),
    and land the decompressed bytes SHARDED over the mesh — one 64 KiB
    image row per chunk, batch axis partitioned over 'd', per-chunk
    CRC-32C verified on each device with ZERO collectives (chunk
    independence, SURVEY.md §7.4).  Only the tiny err vector is
    fetched; the rows stay device-resident.

    Returns (rows, dst_lens, b): rows is a NamedSharding'd
    uint8[B_padded, 65536] jax.Array, dst_lens int32[b] gives each
    row's valid byte count, b the real chunk count.  The single-chip
    flattening form is runtime.device_codec.decompress_framed_to_device.
    ``chunk_range=(lo, cnt)`` restricts staging to that chunk subset —
    the multi-host loader (dist.multihost) gives each host its range.
    """
    from snappy_tpu.errors import ChecksumError
    from snappy_tpu.kernels.crc32c_jnp import crc32c_chunks
    from snappy_tpu.runtime.device_codec import _scan_frames, stage_id_rows

    chunks, _total = _scan_frames(data)
    if chunk_range is not None:  # multi-host: this host's range only
        lo, cnt = chunk_range
        chunks = chunks[lo:lo + cnt]
    src_arr = np.frombuffer(data, np.uint8)
    B = len(chunks)
    b_u8 = np.zeros((max(B, 1), _ID_ROWS * 128), np.uint8)
    dlens = np.zeros(max(B, 1), np.int32)
    want = np.zeros(max(B, 1), np.uint32)
    stage_id_rows(src_arr, chunks, b_u8, dlens, want)
    (b_u8_p, dlens_p, want_p), b = _pad_to_mesh(mesh, b_u8, dlens, want)
    arrs = _shard_batch(mesh, b_u8_p, dlens_p, want_p)

    def _local(rows, dl, w):
        nb = rows.shape[0]
        out = rows.reshape(nb, _ID_ROWS, 128)[:, :512].reshape(
            nb, 512 * 128)
        crc = crc32c_chunks(out, dl)
        err = jnp.where((crc != w) & (dl > 0), jnp.int32(100),
                        jnp.int32(0))
        return out, err

    with mesh:
        out, err = jax.jit(jax.shard_map(
            _local, mesh=mesh,
            in_specs=(P("d"), P("d"), P("d")),
            out_specs=(P("d"), P("d")),
        ))(*arrs)
    if verify_checksums:
        err_h = np.asarray(err)[:B]  # tiny D2H; the rows stay put
        for i in np.nonzero(err_h == 100)[0]:
            raise ChecksumError(chunks[int(i)][3], None)
    return out, dlens[:B], min(B, b)


def sharded_compress_framed_from_device(
    mesh: Mesh, rows, lens: np.ndarray,
) -> bytes:
    """Stream-level from-device ENCODE over the mesh (the encode half
    of the data-loader story; decode half is
    sharded_decompress_framed_to_device, whose (rows, dst_lens, b)
    output this accepts directly): chunk rows living sharded in HBM
    become one framed .sz stream.  Per-chunk CRC-32C runs on each
    device's shard with ZERO collectives (chunk independence);
    the D2H row fetch feeds the threaded C++ matcher; assembly is
    chunk-ordered on host, so no cross-host length gather is needed
    beyond what dist.multihost already does for host-split streams.

    rows: uint8[B, 65536] jax.Array (any sharding; re-sharded over
    'd' if needed — B must be a mesh multiple, as the loader returns).
    lens: int[b] valid byte count per row, b <= B; rows past b are
    padding and emit nothing.  Byte-identical to
    compress_framed(concat of the row bytes)."""
    from snappy_tpu.spec.format import STREAM_ID_CHUNK

    return bytes(STREAM_ID_CHUNK) + b"".join(
        sharded_encode_rows_to_chunks(mesh, rows, lens))


def sharded_encode_rows_to_chunks(
    mesh: Mesh, rows, lens: np.ndarray,
) -> list[bytes]:
    """From-device encode to PER-CHUNK framed records (header + masked
    CRC + payload, no stream id): the composable form —
    sharded_compress_framed_from_device prepends the stream id for a
    whole stream; dist.multihost.host_compress_framed_from_device
    allgathers the record lengths and pwrites records at global
    offsets (the same assembly contract as host_compress_framed)."""
    from snappy_tpu import native
    from snappy_tpu.kernels.crc32c_jnp import CHUNK as _CRC_CHUNK, crc32c_chunks
    from snappy_tpu.spec.format import (
        CHUNK_UNCOMPRESSED,
        framed_chunk_type,
        mask_crc,
        put_uvarint,
    )

    B = int(rows.shape[0])
    b = len(lens)
    assert rows.shape[1] == _CRC_CHUNK and b <= B
    lens_p = np.zeros(B, np.int32)
    lens_p[:b] = lens
    sharding = NamedSharding(mesh, P("d"))
    rows_d = jax.device_put(rows, sharding)
    lens_d = jax.device_put(lens_p, sharding)
    with mesh:
        crc = jax.jit(jax.shard_map(
            lambda r, ln: crc32c_chunks(r, ln), mesh=mesh,
            in_specs=(P("d"), P("d")), out_specs=P("d"),
        ))(rows_d, lens_d)
    # D2H drains overlap the (already dispatched) CRC graph
    for h in (rows_d, crc):
        if hasattr(h, "copy_to_host_async"):
            h.copy_to_host_async()
    if b == 0:
        return []
    blocks = np.asarray(rows_d)[:b]
    crcs = np.asarray(crc)[:b]
    if native.available() and bool(np.all(lens_p[:b - 1] == _CRC_CHUNK)):
        # Full middle rows (the loader contract): the fetched row
        # matrix is the contiguous chunk byte stream, so matching +
        # framing + assembly is ONE threaded C++ call with the device
        # CRCs passed through; rec_lens splits the buffer back into
        # the per-chunk records the multi-host assembly contract needs.
        rl = np.zeros(b, np.uint64)
        buf = native.compress_framed_crc(
            blocks, int(lens_p[:b].sum()), crcs,
            chunk_size=_CRC_CHUNK,
            threads=min(4, os.cpu_count() or 1),
            write_id=False, rec_lens=rl)
        offs = np.concatenate(([0], np.cumsum(rl.astype(np.int64))))
        return [buf[offs[i]:offs[i + 1]] for i in range(b)]
    if native.available():
        lens64 = lens_p[:b].astype(np.int64)
        clens64 = np.zeros(b, np.int64)
        hdrs64 = np.zeros(b, np.int64)
        rc64 = np.zeros(b, np.int64)
        elem_buf = np.empty(
            (b, native.max_compressed_length(_CRC_CHUNK) + 8), np.uint8)
        bad = native.compress_batch(
            blocks, lens64, elem_buf, clens64, hdrs64, rc64,
            n_threads=min(4, os.cpu_count() or 1))
        if bad:  # pragma: no cover
            raise RuntimeError("native compressor rejected a block")
        elems = [
            elem_buf[i, int(hdrs64[i]):int(clens64[i])].tobytes()
            for i in range(b)
        ]
    else:  # portable degrade: per-chunk oracle encode
        from snappy_tpu.spec import reference

        elems = [
            reference.encode_block(blocks[i, :int(lens_p[i])].tobytes())
            for i in range(b)
        ]
    recs = []
    for i in range(b):
        chunk_len = int(lens_p[i])
        body = put_uvarint(chunk_len) + elems[i]
        chunk_type = framed_chunk_type(chunk_len, len(body))
        if chunk_type == CHUNK_UNCOMPRESSED:
            body = blocks[i, :chunk_len].tobytes()
        blen = len(body) + 4
        recs.append(
            bytes((chunk_type, blen & 0xFF, (blen >> 8) & 0xFF,
                   (blen >> 16) & 0xFF))
            + mask_crc(int(crcs[i])).to_bytes(4, "little") + body)
    return recs


def sharded_crc(mesh: Mesh, blocks: np.ndarray, lens: np.ndarray):
    """Encode-side device work of the id path: per-chunk CRC-32C of the
    uncompressed blocks (uint8[B, 65536]) over the mesh, zero
    collectives.  Returns host uint32[B]."""
    from snappy_tpu.kernels.crc32c_jnp import crc32c_chunks

    (blocks, lens), b = _pad_to_mesh(mesh, blocks, lens)
    arrs = _shard_batch(mesh, blocks, lens)
    with mesh:
        crc = jax.jit(jax.shard_map(
            lambda bl, ln: crc32c_chunks(bl, ln), mesh=mesh,
            in_specs=(P("d"), P("d")), out_specs=P("d"),
        ))(*arrs)
    return np.asarray(crc)[:b]


@functools.partial(jax.jit, static_argnames=("bmax",))
def _roundtrip_jit(blocks, lens, bmax: int):
    """The full device pipeline in ONE jitted graph: parallel encode of
    every block, then parallel decode of the produced element streams,
    plus an exclusive scan of compressed lengths (the offsets the framed
    assembler uses).  This is the 'training step' equivalent the
    multi-chip dry run compiles over a mesh."""
    comp, clen, ok = encode_jnp.encode_blocks(blocks, lens, bmax=bmax)
    offsets = jnp.cumsum(clen) - clen  # exclusive scan over block lengths
    starts = jnp.zeros_like(clen)
    out, err = decode_jnp.decode_blocks(comp, starts, clen, lens, out_max=bmax)
    match = jnp.all(jnp.where(
        jnp.arange(bmax)[None, :] < lens[:, None], out == blocks, True
    ))
    return comp, clen, ok, offsets, out, err, match


def roundtrip_step(mesh: Mesh, blocks: np.ndarray, lens: np.ndarray, bmax: int):
    """Run the jitted encode->scan->decode pipeline sharded over a mesh."""
    blocks_d, lens_d = _shard_batch(mesh, blocks, lens)
    with mesh:
        return _roundtrip_jit(blocks_d, lens_d, bmax=bmax)
