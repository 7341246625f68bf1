"""Multi-host data-parallel codec (BASELINE config 5).

Each host process owns a contiguous range of 64 KiB chunks, compresses
or decompresses them on its local chips, and the only DCN traffic is the
per-chunk compressed-length allgather so every host can compute global
output offsets (exclusive scan) for its writes.  Bit-for-bit parity with
single-host output is structural: block encodings are position
independent.

Run one process per host (the reference ships every documented command
as a real entry point, cmd/snappy/main.go:42-60 — so does this module):

    python -m snappy_tpu.dist.multihost --coordinator HOST:PORT \
        --num-processes N --process-id I compress IN OUT

Every process writes its own chunk range into OUT at its global offset
(os.pwrite; ranges are disjoint) and prints one JSON stats line; the
2-process parity test drives this entry point end to end.
"""

from __future__ import annotations

import numpy as np

from snappy_tpu.spec.format import MAX_CHUNK_UNCOMPRESSED

__all__ = [
    "plan_ranges",
    "plan_chunk_ranges",
    "host_compress_framed",
    "host_decompress_framed",
    "host_decompress_framed_to_device",
    "host_compress_framed_from_device",
    "gather_lengths",
    "main",
]


def plan_ranges(total_bytes: int, num_hosts: int,
                chunk_size: int = MAX_CHUNK_UNCOMPRESSED):
    """Split a stream into per-host contiguous chunk ranges (balanced to
    within one chunk).  Returns [(chunk_start, chunk_count), ...]."""
    n_chunks = (total_bytes + chunk_size - 1) // chunk_size if total_bytes else 0
    base = n_chunks // num_hosts
    extra = n_chunks % num_hosts
    out = []
    start = 0
    for h in range(num_hosts):
        cnt = base + (1 if h < extra else 0)
        out.append((start, cnt))
        start += cnt
    return out


def plan_chunk_ranges(n_chunks: int, num_hosts: int):
    """Contiguous per-host ranges over an existing chunk list (balanced
    to within one chunk).  Returns [(first_chunk, count), ...]."""
    base = n_chunks // num_hosts
    extra = n_chunks % num_hosts
    out = []
    start = 0
    for h in range(num_hosts):
        cnt = base + (1 if h < extra else 0)
        out.append((start, cnt))
        start += cnt
    return out


def host_decompress_framed(src: bytes, process_id: int, num_processes: int,
                           verify_checksums: bool = True):
    """Decompress this host's chunk range of a framed stream (BASELINE
    config 5, decompress side).

    Every host scans the frame index locally (headers carry each chunk's
    decoded size, so global output offsets are an exclusive scan with NO
    collective — decompress needs zero DCN traffic; SURVEY.md §7.4).
    Returns (out_offset, local_bytes, total_len, stats) where stats
    carries the per-host GB/s accounting the scaling report aggregates.
    """
    import time

    from snappy_tpu.runtime import device_codec

    t0 = time.perf_counter()
    chunks, total = device_codec._scan_frames(src)
    ranges = plan_chunk_ranges(len(chunks), num_processes)
    lo, cnt = ranges[process_id]

    # global output offsets: exclusive scan over decoded sizes
    g_offs = []
    acc = 0
    for ch in chunks:
        g_offs.append(acc)
        acc += ch[4]

    out_base = g_offs[lo] if cnt else total
    local_total = (g_offs[lo + cnt - 1] + chunks[lo + cnt - 1][4] - out_base
                   if cnt else 0)
    local_offs = [o - out_base for o in g_offs]
    out = np.empty(max(1, local_total), dtype=np.uint8)
    src_arr = np.frombuffer(src, dtype=np.uint8)
    device_codec.decode_chunk_range(
        src_arr, chunks, local_offs, out, range(lo, lo + cnt), verify_checksums
    )
    dt = time.perf_counter() - t0
    stats = {
        "host": process_id,
        "chunks": cnt,
        "bytes": local_total,
        "seconds": round(dt, 4),
        "gbs": round(local_total / 1e9 / dt, 4) if dt > 0 else None,
    }
    return out_base, out[:local_total].tobytes(), total, stats


def host_decompress_framed_to_device(src: bytes, process_id: int,
                                     num_processes: int, mesh=None,
                                     verify_checksums: bool = True):
    """Decompress this host's chunk range of a framed stream straight
    onto its LOCAL devices (the multi-host data-loading form of config
    5): every host scans the frame index locally and id-stages only its
    contiguous chunk range, rows land sharded over the local mesh with
    per-chunk CRC-32C verified on each device — ZERO DCN collectives,
    and the decompressed bytes never touch host memory as a stream.

    Returns (rows, dst_lens, lo, cnt): rows uint8[cnt_padded, 65536]
    sharded over ``mesh`` (default: a mesh over jax.local_devices()),
    row i of this host = global chunk lo + i with dst_lens[i] valid
    bytes.  Single-chip/stream form: decompress_framed_to_device."""
    import jax

    from snappy_tpu.dist import mesh as dmesh
    from snappy_tpu.runtime import device_codec

    if mesh is None:
        mesh = dmesh.make_mesh(devices=jax.local_devices())
    chunks, _total = device_codec._scan_frames(src)
    lo, cnt = plan_chunk_ranges(len(chunks), num_processes)[process_id]
    rows, dlens, b = dmesh.sharded_decompress_framed_to_device(
        mesh, src, verify_checksums, chunk_range=(lo, cnt))
    return rows, dlens[:b], lo, cnt


def host_compress_framed_from_device(rows, lens: np.ndarray, mesh=None):
    """Encode this host's DEVICE-RESIDENT chunk rows into framed chunk
    records (the from-device multi-host encode — config 5 with the
    payload starting in HBM, e.g. straight from the loader or a model):
    per-chunk CRC-32C runs on the local mesh's devices before the rows
    leave the chips, the local matcher emits, and the caller assembles
    exactly as with host_compress_framed — allgather the lengths (the
    one DCN collective), exclusive-scan offsets, pwrite disjoint
    ranges.  Returns (bodies, lengths).

    rows: uint8[B, 65536] jax.Array on this host's devices (B a local
    mesh multiple, as host_decompress_framed_to_device returns); lens:
    valid bytes per row.  Full circle with that loader:
    rows in -> records out, bit-identical to the host-bytes path."""
    import jax

    from snappy_tpu.dist import mesh as dmesh

    if mesh is None:
        mesh = dmesh.make_mesh(devices=jax.local_devices())
    bodies = dmesh.sharded_encode_rows_to_chunks(mesh, rows, lens)
    lengths = np.array([len(b) for b in bodies], dtype=np.int64)
    return bodies, lengths


def gather_lengths(local_lengths: np.ndarray) -> np.ndarray:
    """Allgather per-chunk compressed lengths across hosts (the single
    DCN collective of the codec).  Single-process: identity.

    Hosts own different chunk counts (balanced within one), and
    process_allgather requires uniform shapes, so the counts are
    exchanged first and the payload is padded to the max."""
    import jax

    if jax.process_count() == 1:
        return local_lengths
    from jax.experimental import multihost_utils

    local = np.asarray(local_lengths, dtype=np.int64)
    counts = multihost_utils.process_allgather(
        np.array([len(local)], dtype=np.int64), tiled=False
    ).reshape(-1)
    cap = int(counts.max())
    padded = np.zeros(cap, dtype=np.int64)
    padded[: len(local)] = local
    gathered = multihost_utils.process_allgather(padded, tiled=False).reshape(
        len(counts), cap
    )
    return np.concatenate([gathered[h, : counts[h]] for h in range(len(counts))])


def host_compress_framed(data_local: bytes, chunk_start: int,
                         chunk_size: int = MAX_CHUNK_UNCOMPRESSED):
    """Compress this host's chunk range; returns (bodies, lengths) where
    bodies[i] is the full framed chunk record (header+crc+payload) for
    global chunk index chunk_start + i.

    The caller allgathers lengths, computes offsets with an exclusive
    scan, and writes bodies at offset 10 + sum(lengths of prior chunks)
    (10 = stream-identifier chunk written by host 0).
    """
    from snappy_tpu.runtime import device_codec
    from snappy_tpu.spec.format import (
        CHUNK_COMPRESSED,
        CHUNK_UNCOMPRESSED,
        framed_chunk_type,
        mask_crc,
        put_uvarint,
    )

    data_v = memoryview(data_local)
    bodies = []
    for idx, chunk_len, blob, crc in device_codec._encode_batches(
            data_local, chunk_size):
        off = idx * chunk_size
        chunk = bytes(data_v[off : off + chunk_len])
        checksum = mask_crc(
            crc if crc is not None else device_codec._crc32c_host(chunk))
        body = put_uvarint(chunk_len) + blob
        ctype = framed_chunk_type(chunk_len, len(body))
        if ctype == CHUNK_UNCOMPRESSED:
            body = chunk
        blen = len(body) + 4
        rec = (
            bytes((ctype, blen & 0xFF, (blen >> 8) & 0xFF, (blen >> 16) & 0xFF))
            + checksum.to_bytes(4, "little")
            + body
        )
        bodies.append(rec)
    lengths = np.array([len(b) for b in bodies], dtype=np.int64)
    return bodies, lengths


# ---------------------------------------------------------------------
# CLI entry point (one process per host)

def _ensure_outfile(path: str, size: int, process_id: int) -> None:
    """Rank 0 sizes the output file, everyone barriers, then every rank
    idempotently re-ensures it locally (covers hosts without a shared
    filesystem).  Disjoint pwrite ranges make the parallel writes safe."""
    import os

    import jax

    if process_id == 0:
        with open(path, "wb") as f:
            f.truncate(size)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("snappy-tpu-outfile")
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        if os.fstat(fd).st_size < size:
            os.ftruncate(fd, size)
    finally:
        os.close(fd)


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys
    import time

    p = argparse.ArgumentParser(
        prog="python -m snappy_tpu.dist.multihost",
        description="Multi-host data-parallel framed snappy codec: run "
        "one process per host; each owns a contiguous chunk range and "
        "writes it into OUT at its global offset.",
    )
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordination service address "
                        "(required when --num-processes > 1)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--chunk-size", type=int, default=MAX_CHUNK_UNCOMPRESSED)
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu) before "
                        "distributed init — test/CI seam")
    p.add_argument("--no-verify", action="store_true",
                   help="skip CRC verification on decompress")
    p.add_argument("command", choices=("compress", "decompress"))
    p.add_argument("infile")
    p.add_argument("outfile")
    args = p.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.num_processes > 1:
        if not args.coordinator:
            p.error("--coordinator is required when --num-processes > 1")
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from snappy_tpu.spec.format import STREAM_ID_CHUNK

    pid, nproc = args.process_id, args.num_processes
    with open(args.infile, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    if args.command == "compress":
        ranges = plan_ranges(len(data), nproc, args.chunk_size)
        start, cnt = ranges[pid]
        lo = start * args.chunk_size
        hi = min(len(data), (start + cnt) * args.chunk_size)
        bodies, lengths = host_compress_framed(
            data[lo:hi], start, args.chunk_size)
        all_lengths = gather_lengths(lengths)
        blob = b"".join(bodies)
        off = len(STREAM_ID_CHUNK) + int(all_lengths[:start].sum())
        total_out = len(STREAM_ID_CHUNK) + int(all_lengths.sum())
        _ensure_outfile(args.outfile, total_out, pid)
        fd = os.open(args.outfile, os.O_RDWR)
        try:
            if pid == 0:
                os.pwrite(fd, STREAM_ID_CHUNK, 0)
            if blob:
                os.pwrite(fd, blob, off)
        finally:
            os.close(fd)
        dt = time.perf_counter() - t0
        stats = {
            "host": pid, "command": "compress", "chunks": cnt,
            "bytes_in": hi - lo, "bytes_out": len(blob),
            "seconds": round(dt, 4),
            "gbs": round((hi - lo) / 1e9 / dt, 4) if dt > 0 else None,
        }
    else:
        base, blob, total, stats = host_decompress_framed(
            data, pid, nproc, verify_checksums=not args.no_verify)
        _ensure_outfile(args.outfile, total, pid)
        fd = os.open(args.outfile, os.O_RDWR)
        try:
            if blob:
                os.pwrite(fd, blob, base)
        finally:
            os.close(fd)
        stats = dict(stats, command="decompress")
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
