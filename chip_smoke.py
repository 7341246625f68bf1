#!/usr/bin/env python
"""Chip smoke test: the framed codec's main path on the GPU, at the size
a data loader uses.

One card (the default): a seeded Silesia-like stream of --bytes (1 GiB)
goes through the public entry points a user calls — compress_framed /
decompress_framed on the device backend, decompress_framed_to_device /
compress_framed_from_device, raw compress / decompress /
decompress_to_device, and checkpoint save_pytree / load_pytree — and
every result is compared with the native C++ codec, the pure-Python
oracle in spec/, or the input bytes.  The device CRC kernel is checked
against the table oracle and timed.

Four cards (--chips 4): only the sharded loader
(dist.mesh.sharded_decompress_framed_to_device) and the sharded
from-device encode, over a 4 GiB stream (1 GiB per card), and what
they are compared with.

Exits nonzero, printing no result, on any mismatch, on any platform but
"gpu", or without the native library.  The last line of stdout is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.

Usage:
    python chip_smoke.py                # one card, 1 GiB
    python chip_smoke.py --bytes N      # another stream size
    python chip_smoke.py --chips 4      # the four-card sharded path
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _ROOT)

SEED = 20260816  # bench.corpus default: the benchmark's corpus
CHUNK = 65536


class SmokeError(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def card_line() -> str:
    """nvidia-smi's name and power limit of every card, from a child
    process that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(r.stdout.strip().splitlines())


def make_data(nbytes: int, seed: int = SEED) -> bytes:
    """Exactly nbytes of the seeded Silesia-like corpus (tiled past the
    corpus' own size, which lands a little under the request)."""
    from snappy_tpu.bench.corpus import make_corpus

    data = b"".join(d for _, d in make_corpus(nbytes, seed=seed))
    while len(data) < nbytes:
        data += data[: nbytes - len(data)]
    return data[:nbytes]


def _chunk_records(fr: bytes):
    """(type, payload_off, payload_len, crc, dst_len, hdr) per data chunk
    of a framed stream; a chunk's record starts 8 bytes before its
    payload (4-byte header, 4-byte masked CRC)."""
    from snappy_tpu.runtime.device_codec import _scan_frames

    return _scan_frames(fr)[0]


def phase_compress(data: bytes, sample: int = 64) -> bytes:
    """Phase 2: compress_framed on the device backend, byte-identical to
    the native codec; sampled chunks no longer than the reference
    encoder's emission and decoded by the pure-Python oracle."""
    import numpy as np

    import snappy_tpu
    from snappy_tpu import native
    from snappy_tpu.spec import framing
    from snappy_tpu.spec.format import STREAM_ID_CHUNK

    fr = snappy_tpu.compress_framed(data, backend="jnp")
    check(fr == native.compress_framed(data),
          "compress_framed(backend='jnp') differs from native")
    chunks = _chunk_records(fr)
    n = len(chunks)
    idx = sorted(set(np.linspace(0, n - 1, min(sample, n)).astype(int)))
    for i in idx:
        ctype, p_off, p_len, _crc, dst_len, _hdr = chunks[i]
        src = data[i * CHUNK: i * CHUNK + dst_len]
        record = fr[p_off - 8: p_off + p_len]
        oracle = framing.compress_framed(src)[len(STREAM_ID_CHUNK):]
        check(len(record) <= len(oracle),
              f"chunk {i}: {len(record)} B > reference {len(oracle)} B")
        check(framing.decompress_framed(STREAM_ID_CHUNK + record) == src,
              f"chunk {i}: oracle decode mismatch")
    return fr


def phase_decompress(fr: bytes, data: bytes) -> None:
    """Phase 3: decompress_framed on the device backend."""
    import snappy_tpu

    check(snappy_tpu.decompress_framed(fr, backend="jnp") == data,
          "decompress_framed(backend='jnp') mismatch")


def _on_accelerator(arr) -> bool:
    import jax

    want = jax.devices()[0]
    return arr.devices() == {want}


def phase_loader(fr: bytes, data: bytes) -> None:
    """Phase 4: decompress_framed_to_device lands the stream on the
    device, and a flipped stored CRC is caught by the DEVICE CRC
    (ChecksumError with actual None; a host check fills actual in)."""
    import jax
    import numpy as np

    import snappy_tpu
    from snappy_tpu.errors import ChecksumError
    from snappy_tpu.spec.format import CHUNK_COMPRESSED

    dev = snappy_tpu.decompress_framed_to_device(fr)
    check(isinstance(dev, jax.Array), "loader did not return a jax.Array")
    check(_on_accelerator(dev), f"loader output on {dev.devices()}")
    check(dev.shape == (len(data),), f"loader shape {dev.shape}")
    check(np.array_equal(np.asarray(dev),
                         np.frombuffer(data, np.uint8)),
          "decompress_framed_to_device mismatch")
    del dev
    chunks = _chunk_records(fr)
    comp = [c for c in chunks if c[0] == CHUNK_COMPRESSED]
    check(comp, "stream has no compressed chunk to corrupt")
    p_off = comp[len(comp) // 2][1]
    bad = bytearray(fr)
    bad[p_off - 4] ^= 0x01  # stored masked CRC, first byte
    try:
        snappy_tpu.decompress_framed_to_device(bytes(bad))
    except ChecksumError as e:
        check(e.actual is None,
              "checksum failure came from a host check, not the device")
    else:
        raise SmokeError("a corrupted chunk CRC went undetected")


def phase_from_device(data: bytes, fr: bytes) -> None:
    """Phase 5: compress_framed_from_device of the device-resident input
    equals phase 2's stream."""
    import jax
    import numpy as np

    import snappy_tpu

    arr = jax.device_put(np.frombuffer(data, np.uint8))
    check(snappy_tpu.compress_framed_from_device(arr) == fr,
          "compress_framed_from_device differs from compress_framed")


def phase_raw(data: bytes) -> None:
    """Phase 6: raw compress / decompress / decompress_to_device."""
    import numpy as np

    import snappy_tpu
    from snappy_tpu import native

    raw = snappy_tpu.compress(data, backend="jnp")
    check(raw == native.compress(data), "raw compress differs from native")
    check(snappy_tpu.decompress(raw, backend="jnp") == data,
          "raw decompress mismatch")
    dev = snappy_tpu.decompress_to_device(raw)
    check(_on_accelerator(dev), f"raw loader output on {dev.devices()}")
    check(np.array_equal(np.asarray(dev), np.frombuffer(data, np.uint8)),
          "decompress_to_device mismatch")


def phase_crc(data: bytes, rows: int = 64, tail: int = 12345) -> None:
    """Phase 7: crc32c_chunks on `rows` full rows plus a ragged tail
    equals the table oracle per row, and equals native CRC-32C over
    every chunk of the stream."""
    import jax.numpy as jnp
    import numpy as np

    from snappy_tpu import native
    from snappy_tpu.kernels.crc32c_jnp import crc32c_chunks
    from snappy_tpu.spec.crc32c import crc32c as oracle

    src = np.frombuffer(data, np.uint8)
    check(len(src) >= rows * CHUNK + tail, "stream too short for phase 7")
    blk = np.zeros((rows + 1, CHUNK), np.uint8)
    blk[:rows] = src[: rows * CHUNK].reshape(rows, CHUNK)
    blk[rows, :tail] = src[rows * CHUNK: rows * CHUNK + tail]
    lens = np.array([CHUNK] * rows + [tail], np.int32)
    got = np.asarray(crc32c_chunks(blk, lens))
    for i in range(rows + 1):
        check(int(got[i]) == oracle(blk[i, : lens[i]].tobytes()),
              f"device CRC row {i} differs from the table oracle")
    n_chunks = -(-len(src) // CHUNK)
    for base in range(0, n_chunks, rows):
        cnt = min(rows, n_chunks - base)
        part = src[base * CHUNK: (base + cnt) * CHUNK]
        b = np.zeros((rows, CHUNK), np.uint8)
        b.reshape(-1)[: len(part)] = part
        ln = np.zeros(rows, np.int32)
        ln[:cnt] = np.minimum(len(part) - np.arange(cnt) * CHUNK, CHUNK)
        dev = np.asarray(crc32c_chunks(jnp.asarray(b), jnp.asarray(ln)))
        for i in range(cnt):
            want = native.crc32c_arr(part[i * CHUNK: i * CHUNK + ln[i]])
            check(int(dev[i]) == want, f"device CRC chunk {base + i}")


def _device_time_ns(trace_dir: str) -> tuple[int, int]:
    """Summed duration of every event on the GPU's stream lines in a
    jax.profiler trace (the kernels and device copies the traced calls
    ran): (ns, events)."""
    from jax.profiler import ProfileData

    total = count = 0
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    total += ev.duration_ns
                    count += 1
    return total, count


def time_crc(data: bytes, rows: int = 64, reps: int = 20) -> dict:
    """Device time of crc32c_chunks at `rows` full rows, alone and inside
    the id decode graph (_decode_id_and_crc): the GPU stream events of
    `reps` back-to-back calls in a profiler trace, per call; the
    host-clock time per call (block_until_ready) beside it."""
    import jax
    import numpy as np

    from snappy_tpu.kernels.crc32c_jnp import crc32c_chunks
    from snappy_tpu.runtime.device_codec import _ID_ROWS, _decode_id_and_crc

    src = np.frombuffer(data[: rows * CHUNK], np.uint8).reshape(rows, CHUNK)
    blocks = jax.device_put(src)
    lens = jax.device_put(np.full(rows, CHUNK, np.int32))
    staged = np.zeros((rows, _ID_ROWS * 128), np.uint8)
    staged[:, :CHUNK] = src
    staged = jax.device_put(staged)
    want = jax.device_put(crc32c_chunks(blocks, lens))
    calls = {
        "crc32c_chunks": lambda: crc32c_chunks(blocks, lens),
        "_decode_id_and_crc": lambda: _decode_id_and_crc(staged, lens, want),
    }
    out = {}
    tdir = tempfile.mkdtemp(prefix=".chip_smoke_trace_", dir=_ROOT)
    try:
        for name, fn in calls.items():
            jax.block_until_ready(fn())  # compile + warm
            t0 = time.perf_counter()
            for _ in range(reps):
                r = fn()
            jax.block_until_ready(r)
            host_s = (time.perf_counter() - t0) / reps
            sub = os.path.join(tdir, name)
            with jax.profiler.trace(sub):
                for _ in range(reps):
                    r = fn()
                jax.block_until_ready(r)
            dev_ns, n_ev = _device_time_ns(sub)
            per_call = dev_ns / reps if n_ev else None
            out[name] = {
                "rows": rows,
                "bytes": rows * CHUNK,
                "host_clock_s_per_call": host_s,
                "device_s_per_call": per_call / 1e9 if per_call else None,
                "device_events_per_call": n_ev / reps,
                "device_GBps": rows * CHUNK / per_call if per_call else None,
            }
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    return out


def make_tree(nbytes: int, seed: int = SEED) -> dict:
    """A checkpoint-like dict of random bf16 / f32 / int32 device arrays
    (~nbytes in all: a quarter bf16, half f32, a quarter int32)."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = max(1, nbytes // 4)
    return {
        "w_bf16": jax.random.normal(k1, (q // 2,), jnp.bfloat16),
        "w_f32": jax.random.normal(k2, (q // 2,), jnp.float32),
        "step_i32": jax.random.randint(k3, (q // 4,), 0, 1 << 30,
                                       jnp.int32),
    }


def phase_checkpoint(nbytes: int) -> int:
    """Phase 8: save_pytree / load_pytree round trip, bit-exact, with
    the loaded leaves on the device.  Returns the container size."""
    import jax
    import jax.numpy as jnp

    from snappy_tpu import checkpoint

    tree = make_tree(nbytes)
    blob = checkpoint.save_pytree(tree)
    back = checkpoint.load_pytree(blob)
    check(sorted(back) == sorted(tree), "checkpoint leaf names differ")
    for k, v in tree.items():
        b = back[k]
        check(_on_accelerator(b), f"leaf {k} loaded on {b.devices()}")
        check(b.dtype == v.dtype and b.shape == v.shape, f"leaf {k} meta")
        bits = jnp.uint16 if v.dtype == jnp.bfloat16 else jnp.uint32
        same = jnp.array_equal(jax.lax.bitcast_convert_type(b, bits),
                               jax.lax.bitcast_convert_type(v, bits))
        check(bool(same), f"leaf {k} not bit-exact")
    return len(blob)


def quarter_distinct(data: bytes, parts: int) -> bytes:
    """`parts` copies of data, copy q XORed with the byte q: the same
    compressibility, but no two shards hold the same bytes (a shard
    landing in the wrong place cannot go unnoticed)."""
    import numpy as np

    src = np.frombuffer(data, np.uint8)
    return b"".join((src ^ np.uint8(q)).tobytes() for q in range(parts))


def run_sharded(nbytes_per_card: int, chips: int, say) -> None:
    """The four-card path: the sharded loader and the sharded
    from-device encode, against the input and the native codec."""
    import jax
    import numpy as np

    from snappy_tpu import native
    from snappy_tpu.dist import mesh as dmesh

    devs = jax.devices()
    check(len(devs) >= chips, f"need {chips} devices, have {len(devs)}")
    t0 = time.perf_counter()
    data = quarter_distinct(make_data(nbytes_per_card), chips)
    fr = native.compress_framed(data)
    say(f"data: {len(data)} B, framed {len(fr)} B", t0)

    mesh = dmesh.make_mesh(chips)
    t0 = time.perf_counter()
    rows, dlens, b = dmesh.sharded_decompress_framed_to_device(mesh, fr)
    jax.block_until_ready(rows)
    say("sharded_decompress_framed_to_device", t0)
    shards = rows.addressable_shards
    owners = {s.device for s in shards}
    check(len(shards) == chips and len(owners) == chips
          and owners == set(devs[:chips]),
          f"rows on {sorted(str(d) for d in owners)}")
    for s in shards:
        check(s.data.shape[0] == rows.shape[0] // chips,
              f"shard on {s.device} holds {s.data.shape[0]} rows")
    host = np.asarray(rows)[:b].reshape(-1)[: len(data)]
    check(np.array_equal(host, np.frombuffer(data, np.uint8)),
          "sharded loader bytes differ from the input")
    del host
    t0 = time.perf_counter()
    fr2 = dmesh.sharded_compress_framed_from_device(mesh, rows, dlens[:b])
    say("sharded_compress_framed_from_device", t0)
    check(fr2 == fr, "sharded from-device stream differs from native")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bytes", type=int, default=1 << 30,
                    help="stream size per card (default 1 GiB)")
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded four-card path")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    from snappy_tpu import native
    from snappy_tpu.utils.jaxcache import cache_dir

    if not native.available():
        print("chip_smoke: native library unavailable", file=sys.stderr)
        return 3
    card = card_line()

    def say(what: str, t0: float) -> None:
        print(f"{what}: {time.perf_counter() - t0:.3f} s [{card}]",
              flush=True)

    t0 = time.perf_counter()
    print(f"phase 1 device: {devs} platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}", flush=True)
    print(f"card: {card}", flush=True)
    if args.chips == 4:
        run_sharded(args.bytes, 4, say)
    else:
        data = make_data(args.bytes)
        say(f"data: {len(data)} B seeded corpus", t0)
        t0 = time.perf_counter()
        fr = phase_compress(data)
        say(f"phase 2 compress_framed ({len(fr)} B)", t0)
        t0 = time.perf_counter()
        phase_decompress(fr, data)
        say("phase 3 decompress_framed", t0)
        t0 = time.perf_counter()
        phase_loader(fr, data)
        say("phase 4 decompress_framed_to_device + device CRC reject", t0)
        t0 = time.perf_counter()
        phase_from_device(data, fr)
        say("phase 5 compress_framed_from_device", t0)
        del fr
        t0 = time.perf_counter()
        phase_raw(data[: min(len(data), 256 << 20)])
        say("phase 6 raw compress/decompress/decompress_to_device", t0)
        t0 = time.perf_counter()
        phase_crc(data)
        timing = time_crc(data)
        say("phase 7 crc32c_chunks vs oracle + native", t0)
        print("crc timing: " + json.dumps(timing), flush=True)
        del data
        t0 = time.perf_counter()
        size = phase_checkpoint(min(args.bytes // 2, 512 << 20))
        say(f"phase 8 checkpoint save/load ({size} B)", t0)
    stats = devs[0].memory_stats() or {}
    print(f"phase 9 peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
          f"compile_cache={cache_dir()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
