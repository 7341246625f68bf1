"""Config-4 long-stream measurement subprocess: ONE
>= 1 GB single framed stream and one >= 1 GB raw stream through the
production host paths, GB/s + peak RSS, printed as one
`LONGSTREAM_JSON {...}` line.

Runs pinned to the CPU platform in its own process so ru_maxrss is the
phase's own footprint (the main bench process has already touched
hundreds of MB of staging) and so it never opens the accelerator the
parent holds (one process per card).  What is measured and why:

- stream_decompress_gbs: the production framed decode to a host
  destination — per docs/architecture.md the id architecture's host
  walk IS the decode for host destinations, so this is the threaded
  native framed codec (the host walk the id path rides; the device
  adds the CRC check, measured separately in the system phase).
- stream_raw_decompress_gbs: a single >= 1 GB RAW snappy stream
  through the public decompress() production route (the id walk; raw
  LZ history makes this inherently single-core).
- stream_compress_gbs: the production framed encode (threaded
  matcher) over the same volume.
- stream_loader_host_gbs: the host half of the to-device loader
  (stage_id_rows over the whole stream into 64 KiB row panels) — the
  device half's rate is the system phase's CRC graphs.
- stream_streaming_decompress_gbs: FramedReader streaming decode of
  the same stream in 1 MB reads (the bounded-residency API; the r3
  CLI test proved 230 MB RSS at 1 GiB, here the rate is recorded).
"""

import json
import os
import resource
import sys
import time


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")  # stay off the card
    import numpy as np

    from snappy_tpu import native
    from snappy_tpu.utils.hostmem import tune_allocator, warm_heap

    if not native.available():
        print("LONGSTREAM_JSON {}")
        return 0
    tune_allocator()
    n = int(os.environ.get("SNAPPY_TPU_BENCH_STREAM_BYTES",
                           str(1 << 30)))
    repeats = int(os.environ.get("SNAPPY_TPU_BENCH_REPEATS", "2"))
    warm_heap(min(4 * n, 6 << 30))
    nt = min(4, os.cpu_count() or 1)

    # Build ONE contiguous enwik-like stream of n bytes (tiled 64 MB
    # body: chunk contents repeat, which matches config 4's ordered-
    # gather shape; throughput is content-insensitive for the walk).
    from snappy_tpu.bench.corpus import make_enwik_like

    body = make_enwik_like(min(n, 64 << 20))
    reps = -(-n // len(body))
    data = (body * reps)[:n]
    del body

    out = {"stream_bytes": n}

    # Preallocated, pre-faulted destination buffers: a fresh multi-GB
    # output is mmap'd and costs ~60 us/page in first-touch faults
    # (measured here: 1 GiB of faults swamps the walk 20x), and no
    # production pipeline re-allocates its output per stream.  The
    # cold-alloc rate is reported alongside so the trade is in-band.
    data_arr = np.frombuffer(data, np.uint8)
    out_buf = np.empty(n, np.uint8)
    out_buf[::4096] = 0  # fault every page once, untimed
    fr_cap = int(native.framed_max_length(n))
    fr_buf = np.empty(fr_cap, np.uint8)
    fr_buf[::4096] = 0

    # framed production encode (into the reused buffer)
    fr_len = native.compress_framed_into(data_arr, fr_buf, threads=nt)
    fr = fr_buf[:fr_len]
    out["stream_framed_bytes"] = fr_len
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        native.compress_framed_into(data_arr, fr_buf, threads=nt)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    out["stream_compress_gbs"] = round(n / 1e9 / best, 4)

    # framed production decode (host destination, reused buffer)
    t0 = time.perf_counter()
    cold = native.decompress_framed(fr.tobytes(), threads=nt)
    out["stream_decompress_coldalloc_gbs"] = round(
        n / 1e9 / (time.perf_counter() - t0), 4)
    assert cold == data, "long framed stream roundtrip mismatch"
    del cold
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        got = native.decompress_framed_into(fr, out_buf, threads=nt)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    assert got == n and out_buf.tobytes() == data
    out["stream_decompress_gbs"] = round(n / 1e9 / best, 4)

    # RAW single stream (one LZ history; the id walk is the engine)
    raw = native.compress(data)
    out["stream_raw_bytes"] = len(raw)
    raw_arr = np.frombuffer(raw, np.uint8)
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        got = native.decompress_into(raw_arr, out_buf)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    assert got == n and out_buf.tobytes() == data, "raw roundtrip"
    del raw, raw_arr
    out["stream_raw_decompress_gbs"] = round(n / 1e9 / best, 4)

    # host half of the to-device loader over the whole framed stream
    from snappy_tpu.runtime.device_codec import _scan_frames, stage_id_rows

    fr_b = fr.tobytes()
    chunks, _total = _scan_frames(fr_b)
    src_arr = np.frombuffer(fr_b, np.uint8)
    B = 256
    rows = np.empty((B, 520 * 128), np.uint8)
    dlens = np.zeros(B, np.int32)
    want = np.zeros(B, np.uint32)
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        for base in range(0, len(chunks), B):
            stage_id_rows(src_arr, chunks[base:base + B], rows, dlens,
                          want)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    out["stream_loader_host_gbs"] = round(n / 1e9 / best, 4)
    out["stream_peak_rss_mb"] = round(_rss_mb(), 1)

    # streaming reader: bounded residency over the same >= 1 GB stream
    import io

    from snappy_tpu.runtime.stream import FramedReader

    t0 = time.perf_counter()
    r = FramedReader(io.BytesIO(fr_b))
    got = 0
    while True:
        piece = r.read(1 << 20)
        if not piece:
            break
        got += len(piece)
    assert got == n
    out["stream_streaming_decompress_gbs"] = round(
        n / 1e9 / (time.perf_counter() - t0), 4)
    out["stream_note"] = (
        "single >=1GB framed + raw streams through the production "
        "host paths (CPU-pinned subprocess for honest peak RSS); "
        "device-half rates are the system phase's fields")
    print("LONGSTREAM_JSON " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
