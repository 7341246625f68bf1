"""Benchmark harness: GB/s accounting through the public API and the
production id path.

Phases of run_bench:

- e2e: bytes-in/bytes-out through the public API, including all host
  work, host<->device transfers, CRC, and assembly.
- device: the portable jnp kernels (decode_jnp, the host-parse hybrid,
  encode_jnp) over K distinct resident batches; completion is forced by
  fetching a scalar that depends on every batch's outputs.
- system: the id path — host stage (threaded C++ walk / matcher) and
  device graph (row slice + CRC-32C) timed together, plus the host-only
  and device-only halves, the from-device encode, a coupled pass with
  the real H2D inside the clock, and the pure-C++ host bar.
- long stream: >= 1 GiB framed + raw streams through the host paths, in
  a CPU-pinned child process (its peak RSS is its own).
- ratio parity against C++ snappy (or the native reference encoder).

Round-trip bytes are verified inside the harness; a benchmark that
returns wrong bytes is invalid, not slow.  A phase that fails fails the
run.
"""

from __future__ import annotations

import os
import time

import numpy as np

from snappy_tpu.utils.hostmem import tune_allocator, warm_heap


def _load_corpus(size: int, corpus_path: str | None):
    if corpus_path and os.path.isdir(corpus_path):
        files = []
        for name in sorted(os.listdir(corpus_path)):
            p = os.path.join(corpus_path, name)
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    files.append((name, f.read()))
        if files:
            return files
    from snappy_tpu.bench.corpus import make_corpus

    return make_corpus(size)


def _ref_sizes(files) -> dict[str, int]:
    sizes = {}
    try:
        import pyarrow as pa

        for name, data in files:
            sizes[name] = len(pa.compress(data, codec="snappy", asbytes=True))
        return sizes
    except ImportError:
        pass
    from snappy_tpu import native

    if native.available():
        for name, data in files:
            sizes[name] = len(native.compress(data))
    return sizes


def _device_path_bench(data: bytes, repeats: int) -> dict:
    """Stage K distinct batches resident; time dispatch->forced-completion
    of the portable jnp kernels."""
    import jax
    import jax.numpy as jnp

    from snappy_tpu.kernels import decode_jnp, encode_jnp
    from snappy_tpu.spec.format import read_uvarint
    from snappy_tpu import native

    B = int(os.environ.get("SNAPPY_TPU_BENCH_DEVBATCH", "128"))
    BMAX, CMAX = 65536, 66560
    n_batches = max(1, min(8, len(data) // (B * BMAX)))
    total = n_batches * B * BMAX

    enc_args = []
    dec_args = []
    dec_args_host = []
    for k in range(n_batches):
        blocks = np.zeros((B, BMAX), np.uint8)
        lens = np.full(B, BMAX, np.int32)
        comp = np.zeros((B, CMAX), np.uint8)
        starts = np.zeros(B, np.int32)
        clens = np.zeros(B, np.int32)
        dlens = np.full(B, BMAX, np.int32)
        for i in range(B):
            off = (k * B + i) * BMAX
            blocks[i] = np.frombuffer(data[off : off + BMAX], np.uint8)
            if native.available():
                c = native.compress(blocks[i].tobytes())
            else:
                from snappy_tpu.kernels import encode_np

                c = encode_np.compress(blocks[i].tobytes())
            _d0, h = read_uvarint(c, 0)
            comp[i, : len(c)] = np.frombuffer(c, np.uint8)
            starts[i], clens[i] = h, len(c)
        enc_args.append((jax.device_put(blocks), jax.device_put(lens)))
        dec_args.append(
            tuple(map(jax.device_put, (comp, starts, clens, dlens)))
        )
        dec_args_host.append((comp, starts, clens))

    combine = jax.jit(lambda *xs: sum(jnp.sum(x) for x in xs))

    # hybrid staging: host-parsed tag records for the pretagged kernel
    hyb_args = []
    if native.available():
        T_CAP = CMAX // 2 + 2  # every element is >= 2 payload bytes
        tmp = np.empty((T_CAP, 4), np.int32)
        for (comp_d, _s, _c, dlens_d), (comp_h, starts_h, clens_h) in zip(
                dec_args, dec_args_host):
            recs = np.zeros((B, 16384, 4), np.int32)
            ntags = np.zeros(B, np.int32)
            ok = True
            for i in range(B):
                nt = native.parse_tags(
                    comp_h[i, : clens_h[i]].tobytes(), int(starts_h[i]),
                    BMAX, tmp)
                if nt > 16384:
                    ok = False
                    break
                recs[i, :nt] = tmp[:nt]
                ntags[i] = nt
            if not ok:
                hyb_args = []
                break
            hyb_args.append((comp_d, jax.device_put(recs),
                             jax.device_put(ntags), dlens_d))

    def run_decode():
        errs = []
        for a in dec_args:
            _out, err = decode_jnp.decode_blocks(*a, out_max=BMAX)
            errs.append(err)
        return int(np.asarray(combine(*errs)))

    def run_decode_hybrid():
        from snappy_tpu.kernels.decode_pretagged import decode_blocks_pretagged

        outs = []
        for comp_d, recs_d, ntags_d, dlens_d in hyb_args:
            out = decode_blocks_pretagged(comp_d, recs_d, ntags_d, dlens_d,
                                          out_max=BMAX)
            outs.append(out[:, :1].astype(jnp.int32))
        return int(np.asarray(combine(*outs)))

    def run_encode():
        cls = []
        for a in enc_args:
            _co, cl, _ok = encode_jnp.encode_blocks(*a, bmax=BMAX)
            cls.append(cl)
        return int(np.asarray(combine(*cls)))

    def timed(fn):
        fn()  # warmup (compile + first exec)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return times

    assert run_decode() == 0, "device decode reported errors"
    dec_times = timed(run_decode)
    enc_times = timed(run_encode)
    out = {
        "device_decompress_gbs": round(total / 1e9 / min(dec_times), 4),
        "device_compress_gbs": round(total / 1e9 / min(enc_times), 4),
        "device_batch_bytes": total,
        "device_decode_times_s": [round(t, 3) for t in dec_times],
        "device_encode_times_s": [round(t, 3) for t in enc_times],
    }
    if hyb_args:
        hyb_times = timed(run_decode_hybrid)
        out["device_decompress_hybrid_gbs"] = round(
            total / 1e9 / min(hyb_times), 4)
        out["device_decompress_gbs"] = max(
            out["device_decompress_gbs"], out["device_decompress_hybrid_gbs"])
    return out


def _system_path_bench(data: bytes, repeats: int,
                       sysbytes: int | None = None,
                       batch: int | None = None) -> dict:
    """SYSTEM-level throughput of the id path: the host stage (threaded
    C++ walk for decode, matcher for encode) and the device graph (row
    slice + per-chunk CRC-32C) timed TOGETHER over a large volume.

    Accounting: outputs stay device-resident and per-chunk integrity
    is checked ON DEVICE (a nonzero err fails the phase).  In the
    pipelined clock the host re-stages every batch while the device
    executes pre-staged copies of the same deterministic rows, so the
    H2D of the staged rows is not inside that clock;
    system_decompress_coupled_gbs puts stage + real H2D + execute in
    one clock.  system_plan_* is the host stage alone and
    system_device_only_* the device graph alone, which shows which half
    bounds the pipelined number.
    """
    import jax
    import jax.numpy as jnp

    from snappy_tpu import native
    from snappy_tpu.kernels.crc32c_jnp import crc32c_chunks
    from snappy_tpu.spec.format import read_uvarint

    if not native.available():
        return {}
    B = batch or int(os.environ.get("SNAPPY_TPU_BENCH_SYSBATCH", "256"))
    BMAX = 65536
    ID_ROWS = 520
    sysbytes = sysbytes or int(
        os.environ.get("SNAPPY_TPU_BENCH_SYSBYTES", str(256 << 20)))
    n_batches = max(1, sysbytes // (B * BMAX))
    need = n_batches * B * BMAX
    if need > len(data):
        from snappy_tpu.bench.corpus import make_corpus as _mk

        data = data + b"".join(
            d for _, d in _mk(need - len(data) + BMAX, seed=17))
    total = n_batches * B * BMAX

    # untimed prep: the decode input (per-block elements — in production
    # these ARE the input stream) and the frame CRCs (carried by the
    # stream's chunk headers)
    elems = []
    hdrs = np.zeros((n_batches, B), np.int32)
    want = np.zeros((n_batches, B), np.uint32)
    for k in range(n_batches):
        row = []
        for i in range(B):
            off = (k * B + i) * BMAX
            block = data[off : off + BMAX]
            c = native.compress(block)
            _, h = read_uvarint(c, 0)
            row.append(np.frombuffer(c, np.uint8))
            hdrs[k, i] = h
            want[k, i] = native.crc32c(block)
        elems.append(row)
    blocks_np = [
        np.frombuffer(
            data[k * B * BMAX : (k + 1) * B * BMAX], np.uint8
        ).reshape(B, BMAX)
        for k in range(n_batches)
    ]
    dlens = np.full(B, BMAX, np.int32)
    want_dev = [jax.device_put(want[k]) for k in range(n_batches)]
    dlens_dev = jax.device_put(dlens)

    n_workers = int(os.environ.get(
        "SNAPPY_TPU_SYS_WORKERS", str(min(4, os.cpu_count() or 1))))
    # per-batch concatenated element buffers for the one-call batch
    # stager (C++ threads)
    ecat = []
    eoffs = np.zeros((n_batches, B), np.int64)
    elens = np.zeros((n_batches, B), np.int64)
    for k in range(n_batches):
        off = 0
        for i in range(B):
            eoffs[k, i] = off
            elens[k, i] = len(elems[k][i])
            off += len(elems[k][i])
        buf = np.empty(off, np.uint8)
        for i in range(B):
            buf[eoffs[k, i]:eoffs[k, i] + elens[k, i]] = elems[k][i]
        ecat.append(buf)
    hdrs64 = hdrs.astype(np.int64)
    dstl64 = np.full(B, BMAX, np.int64)
    blens64 = np.full(B, BMAX, np.int64)
    rc64 = np.zeros(B, np.int64)
    clen64 = np.zeros(B, np.int64)
    hdr64 = np.zeros(B, np.int64)
    elem_buf = np.empty((B, native.max_compressed_length(BMAX) + 8),
                        np.uint8)

    # staging sets: triple-buffered so staging batch k never rewrites
    # host memory a pending transfer of batch k-1/k-2 may still read.
    # Any violation is caught, not silent: the decode graph CRC-checks
    # every chunk on device and a nonzero err fails the phase.
    NSETS = 3
    dec_sets = [np.empty((B, ID_ROWS * 128), np.uint8) for _ in range(NSETS)]

    def _stage_dec_batch(k, rows, workers=None):
        # validate + decode each element straight into its staging row
        # — the whole host half of the decode path
        bad = native.stage_flat_dec_id_batch(
            ecat[k], eoffs[k], elens[k], hdrs64[k], dstl64, ID_ROWS,
            rows, rc64, n_threads=workers or n_workers)
        assert bad == 0, "corpus block failed id staging"
        return rows

    def _stage_enc_batch(k, workers=None):
        # matcher + emission on host (threaded C++); the device graph
        # CRCs the uncompressed blocks
        bad = native.compress_batch(
            blocks_np[k], blens64, elem_buf, clen64, hdr64, rc64,
            n_threads=workers or n_workers)
        assert bad == 0, "native compressor rejected a block"

    dec_dev = [jax.device_put(_stage_dec_batch(k, dec_sets[0]).copy())
               for k in range(n_batches)]
    enc_dev = [jax.device_put(blocks_np[k]) for k in range(n_batches)]

    @jax.jit
    def _dec_graph_id(b_u8, want_k, dlens_k):
        out = b_u8.reshape(B, ID_ROWS, 128)[:, :512].reshape(B, 512 * 128)
        crc = crc32c_chunks(out, dlens_k)
        return jnp.sum((crc != want_k).astype(jnp.int32))

    @jax.jit
    def _enc_graph_id(blocks_k, dlens_k):
        crc = crc32c_chunks(blocks_k, dlens_k)
        return jnp.sum(crc.astype(jnp.int32) & 1)  # force the compute

    combine = jax.jit(lambda *xs: sum(xs))

    # dispatch rides a dedicated worker thread (a real loader splits
    # stage and dispatch the same way); the C++ stagers drop the GIL
    from concurrent.futures import ThreadPoolExecutor

    _dispatcher = ThreadPoolExecutor(1)

    def dec_pass(stage_on_host: bool = True):
        futs = []
        for k in range(n_batches):
            if stage_on_host:
                _stage_dec_batch(k, dec_sets[k % NSETS])
            futs.append(_dispatcher.submit(
                _dec_graph_id, dec_dev[k], want_dev[k], dlens_dev))
        return int(np.asarray(combine(*[f.result() for f in futs])))

    def enc_pass(stage_on_host: bool = True):
        futs = []
        for k in range(n_batches):
            if stage_on_host:
                _stage_enc_batch(k)
            futs.append(_dispatcher.submit(
                _enc_graph_id, enc_dev[k], dlens_dev))
        return int(np.asarray(combine(*[f.result() for f in futs])))

    def best_of(fn, check=None):
        fn()  # warmup (compile + first exec)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            r = fn()
            times.append(time.perf_counter() - t0)
            if check is not None:
                check(r)
        return times

    def _no_crc_errors(bad):
        assert bad == 0, "system decode: device CRC mismatch"

    def _by_workers(stage):
        by_w = {}
        for w in (1, 2, 4):
            t0 = time.perf_counter()
            for k in range(n_batches):
                stage(k, w)
            by_w[str(w)] = round(total / 1e9 / (time.perf_counter() - t0), 4)
        return by_w

    out: dict = {
        "system_bytes": total,
        "system_h2d_bytes_per_out_byte": round(
            (ID_ROWS * 128 + 4 + 4) / BMAX, 3),
    }
    times = best_of(dec_pass, _no_crc_errors)
    out["system_decompress_gbs"] = round(total / 1e9 / min(times), 4)
    out["system_decompress_times_s"] = [round(t, 3) for t in times]
    times = best_of(lambda: [_stage_dec_batch(k, dec_sets[k % NSETS])
                             for k in range(n_batches)])
    out["system_plan_dec_gbs"] = round(total / 1e9 / min(times), 4)
    out["system_plan_dec_by_workers_gbs"] = _by_workers(
        lambda k, w: _stage_dec_batch(k, dec_sets[k % NSETS], workers=w))
    times = best_of(lambda: dec_pass(stage_on_host=False), _no_crc_errors)
    out["system_device_only_dec_gbs"] = round(total / 1e9 / min(times), 4)

    times = best_of(enc_pass)
    out["system_compress_gbs"] = round(total / 1e9 / min(times), 4)
    out["system_compress_times_s"] = [round(t, 3) for t in times]
    times = best_of(lambda: [_stage_enc_batch(k) for k in range(n_batches)])
    out["system_plan_enc_gbs"] = round(total / 1e9 / min(times), 4)
    out["system_plan_enc_by_workers_gbs"] = _by_workers(
        lambda k, w: _stage_enc_batch(k, workers=w))
    times = best_of(lambda: enc_pass(stage_on_host=False))
    out["system_device_only_enc_gbs"] = round(total / 1e9 / min(times), 4)

    # From-device encode: the chunk rows already live on the device
    # (enc_dev); the clock covers device CRC + D2H row fetch + host
    # matcher + framed assembly, through the public API
    from snappy_tpu.runtime import device_codec as _dc

    arr_fd = jnp.concatenate(enc_dev).reshape(-1)
    times = best_of(lambda: _dc.compress_framed_from_device(arr_fd))
    fr_fd = _dc.compress_framed_from_device(arr_fd)
    assert native.decompress_framed(fr_fd) == bytes(data[:total]), (
        "from-device roundtrip")
    out["system_compress_from_device_gbs"] = round(
        total / 1e9 / min(times), 4)

    # coupled decode: stage + real H2D + execute in one clock
    def dec_pass_coupled():
        hs = []
        for k in range(n_batches):
            rows = _stage_dec_batch(k, dec_sets[k % NSETS])
            hs.append(_dec_graph_id(jax.device_put(rows), want_dev[k],
                                    dlens_dev))
        return int(np.asarray(combine(*hs)))

    times = best_of(dec_pass_coupled, _no_crc_errors)
    out["system_decompress_coupled_gbs"] = round(total / 1e9 / min(times), 4)

    # The host bar: the multithreaded pure-C++ framed codec on the SAME
    # volume — the number the system path must beat for the device to
    # add value.  Into-variants with reused destination buffers, the
    # same residency accounting as the system clock.
    nt = min(4, os.cpu_count() or 1)
    resident = np.frombuffer(bytes(data[:total]), np.uint8)
    fr_buf = np.empty(native.framed_max_length(total), np.uint8)
    fl = native.compress_framed_into(resident, fr_buf, threads=nt)
    times = best_of(
        lambda: native.compress_framed_into(resident, fr_buf, threads=nt))
    out["host_native_compress_gbs"] = round(total / 1e9 / min(times), 4)
    back_buf = np.empty(total, np.uint8)
    framed = fr_buf[:fl]
    times = best_of(lambda: native.decompress_framed_into(
        framed, back_buf, threads=nt))
    assert bytes(back_buf) == bytes(resident)
    out["host_native_decompress_gbs"] = round(total / 1e9 / min(times), 4)
    out["host_native_threads"] = nt
    _dispatcher.shutdown()
    return out


def _long_stream_bench() -> dict:
    """Config-4 long-stream phase in a CPU-pinned subprocess so peak RSS
    is the phase's own; see longstream_sub.  The child never opens the
    accelerator (one process per card)."""
    import json as _json
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "snappy_tpu.bench.longstream_sub"],
        capture_output=True, text=True, timeout=1800,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    for line in r.stdout.splitlines():
        if line.startswith("LONGSTREAM_JSON "):
            return _json.loads(line[len("LONGSTREAM_JSON "):])
    raise RuntimeError(
        f"long-stream phase failed (rc {r.returncode}): "
        f"{(r.stderr or r.stdout)[-2000:]}")


def scaling_bench(repeats: int = 4, virtual: bool = False) -> dict:
    """GB/s scaling across the local device mesh (BASELINE config 4):
    decode the same enwik-like block workload on 1 device vs all
    devices.

    Real multi-device mesh: efficiency = speedup / n_devices (strong
    scaling; compute parallelism is physical).

    Virtual CPU mesh (virtual=True): every virtual device shares one
    intra-op thread pool, so speedup/N is structurally ~1/N and
    meaningless.  What the virtual mesh CAN measure is the overhead the
    SPMD partitioner + assembly add to the same total work: efficiency
    = t_1dev / t_ndev.  That is a CPU figure and is never reported as a
    device metric."""
    import jax

    from snappy_tpu.bench.corpus import make_enwik_like
    from snappy_tpu.dist import mesh as dmesh
    from snappy_tpu.spec.format import read_uvarint
    from snappy_tpu import native

    n_dev = len(jax.devices())
    if n_dev < 2:
        raise ValueError("scaling_bench needs at least 2 devices")
    # 16 blocks/device: small enough to stay cache-warm on the virtual
    # mesh, big enough that partitioner overhead dominates noise
    B, BMAX, CMAX = 16 * n_dev, 65536, 66560
    data = make_enwik_like(B * BMAX)
    comp = np.zeros((B, CMAX), np.uint8)
    starts = np.zeros(B, np.int32)
    clens = np.zeros(B, np.int32)
    dlens = np.full(B, BMAX, np.int32)
    for i in range(B):
        c = native.compress(data[i * BMAX : (i + 1) * BMAX])
        _d0, h = read_uvarint(c, 0)
        comp[i, : len(c)] = np.frombuffer(c, np.uint8)
        starts[i], clens[i] = h, len(c)

    times = {}
    for nd in (1, n_dev):
        mesh = dmesh.make_mesh(nd)
        dmesh.sharded_decode(mesh, comp, starts, clens, dlens, out_max=BMAX)  # warm
        best = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            _out, err = dmesh.sharded_decode(
                mesh, comp, starts, clens, dlens, out_max=BMAX
            )
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        assert (err == 0).all()
        times[nd] = best
    if virtual:
        eff = min(1.0, times[1] / times[n_dev])
        note = (
            "virtual mesh shares one thread pool: efficiency is "
            "t_1dev/t_ndev = SPMD partitioning+assembly overhead, not "
            "physical speedup"
        )
    else:
        eff = (times[1] / times[n_dev]) / n_dev
        note = "strong scaling: speedup / n_devices"
    return {
        "scaling_devices": n_dev,
        "scaling_time_1dev_s": round(times[1], 4),
        "scaling_time_ndev_s": round(times[n_dev], 4),
        "scaling_efficiency": round(eff, 4),
        "scaling_note": note,
    }


def run_bench(
    size: int = 32 << 20,
    backend: str | None = None,
    corpus_path: str | None = None,
    repeats: int = 2,
) -> dict:
    tune_allocator()
    warm_heap(min(3 * size + (64 << 20), 1 << 31))

    from snappy_tpu import api

    backend = backend or os.environ.get("SNAPPY_TPU_BACKEND") or "jnp"
    files = _load_corpus(size, corpus_path)
    total = sum(len(d) for _, d in files)
    data_all = b"".join(d for _, d in files)

    import sys

    def note(msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    # -- end-to-end framed, through the public API ------------------------
    # capped volume for the device backend: e2e proves the full
    # bytes-in/bytes-out path; the system phase carries the volume
    e2e_cap = int(os.environ.get("SNAPPY_TPU_BENCH_E2E_CAP", str(4 << 20)))
    if backend == "jnp":
        e2e_files = []
        budget = e2e_cap
        for name, d in files:
            if budget <= 0:
                break
            e2e_files.append((name, d[:budget]))
            budget -= len(e2e_files[-1][1])
    else:
        e2e_files = files
    e2e_total = sum(len(d) for _, d in e2e_files)
    note(f"corpus {total/1e6:.0f}MB, backend={backend}; e2e ({e2e_total/1e6:.0f}MB) warmup...")
    from snappy_tpu.utils.progress import default_meter

    meter = default_meter()
    api.compress_framed(e2e_files[0][1][: 1 << 20], backend=backend)  # warmup
    note("e2e compress...")
    meter.start("e2e compress", e2e_total)
    t0 = time.perf_counter()
    framed = []
    done = 0
    for _, d in e2e_files:
        framed.append(api.compress_framed(d, backend=backend))
        done += len(d)
        meter.set(done)
    e2e_comp_t = time.perf_counter() - t0
    meter.finish()
    note(f"e2e compress done in {e2e_comp_t:.1f}s; e2e decompress...")
    api.decompress_framed(framed[0], backend=backend)  # warmup
    meter.start("e2e decompress", e2e_total)
    t0 = time.perf_counter()
    outs = []
    done = 0
    for b in framed:
        outs.append(api.decompress_framed(b, backend=backend))
        done += len(outs[-1])
        meter.set(done)
    e2e_dec_t = time.perf_counter() - t0
    meter.finish()
    for (name, d), o in zip(e2e_files, outs):
        assert o == d, f"round-trip mismatch on {name}"

    dev: dict = {}
    sys_res: dict = {}
    stream_res: dict = {}
    if backend == "jnp":
        note("device-path phase (jnp kernels)...")
        dev = _device_path_bench(data_all, repeats)
        if os.environ.get("SNAPPY_TPU_BENCH_SYSTEM", "1") != "0":
            note("system-path phase (id stage + device graph)...")
            sys_res = _system_path_bench(data_all, repeats)
        from snappy_tpu import native as _native

        if (os.environ.get("SNAPPY_TPU_BENCH_STREAM", "1") != "0"
                and _native.available()):
            note("long-stream phase (1 GiB framed + raw, subprocess)...")
            stream_res = _long_stream_bench()

    note("ratio parity phase...")
    # -- ratio parity (host np backend: the same parse the device runs) --
    ref_sizes = _ref_sizes(files)
    ours_sizes = {}
    for name, d in files:
        ours_sizes[name] = len(api.compress(d, backend="np"))
    ratio_ok = all(
        ours_sizes[n] <= ref_sizes.get(n, ours_sizes[n]) for n, _ in files
    )
    ratio = total / max(sum(ours_sizes.values()), 1)

    # headline: the SYSTEM number (id stage + device graph) when the
    # phase ran, else the jnp device phase, else e2e
    headline = sys_res.get(
        "system_decompress_gbs",
        dev.get("device_decompress_gbs",
                round(e2e_total / 1e9 / e2e_dec_t, 4)),
    )
    metric = ("system_silesia_decompress" if "system_decompress_gbs"
              in sys_res else "synthetic_silesia_decompress")
    result = {
        "metric": metric,
        "value": headline,
        "unit": "GB/s/chip",
        "vs_baseline": round(headline / 20.0, 4),
        "e2e_decompress_gbs": round(e2e_total / 1e9 / e2e_dec_t, 4),
        "e2e_compress_gbs": round(e2e_total / 1e9 / e2e_comp_t, 4),
        "e2e_bytes": e2e_total,
        "ratio": round(ratio, 4),
        "ratio_le_reference_all_files": bool(ratio_ok),
        "corpus_bytes": total,
        "backend": backend,
        "files": len(files),
    }
    result.update(dev)
    result.update(sys_res)
    result.update(stream_res)
    return result
