#!/usr/bin/env python
"""Encode-matcher per-core ceiling study: where does the per-block time
go, and which levers move the rate?  Identical-emission variants timed
over the bench corpus, plus an instrumented pass that counts the work
items so the cycle budget can be attributed.

Usage: python tools/enc_study.py [--bytes N] [--threads T]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bytes", type=int, default=64 << 20)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    from snappy_tpu import native
    from snappy_tpu.bench.corpus import make_corpus
    from snappy_tpu.utils.hostmem import tune_allocator, warm_heap

    assert native.available()
    tune_allocator()
    warm_heap(4 * args.bytes)

    data = b"".join(d for _, d in make_corpus(args.bytes))
    BMAX = 65536
    nb = len(data) // BMAX
    blocks = np.frombuffer(data[: nb * BMAX], np.uint8).reshape(nb, BMAX)
    lens = np.full(nb, BMAX, np.int64)
    cap = native.max_compressed_length(BMAX) + 8
    dst = np.empty((nb, cap), np.uint8)
    out_lens = np.zeros(nb, np.int64)
    total = nb * BMAX

    # identity anchor: variant 0 and 2 must equal sn_compress emission
    ref = [native.compress(blocks[i].tobytes()) for i in range(min(nb, 64))]
    import snappy_tpu.spec.format as fmt

    for variant in (0, 2, 3):
        native.enc_study(blocks[:64], lens[:64], dst[:64], out_lens[:64],
                         variant)
        for i in range(min(nb, 64)):
            _, hdr = fmt.read_uvarint(ref[i], 0)
            assert dst[i, : out_lens[i]].tobytes() == ref[i][hdr:], (
                variant, i)
    print(f"identity: variants 0,2 byte-identical to sn_compress over "
          f"{min(nb, 64)} blocks")

    names = {0: "baseline-clone", 1: "no-emit", 2: "epoch-table",
             3: "interleave-2"}

    def run(variant, threads):
        if threads == 1:
            t0 = time.perf_counter()
            native.enc_study(blocks, lens, dst, out_lens, variant)
            return time.perf_counter() - t0
        from concurrent.futures import ThreadPoolExecutor

        chunks = np.array_split(np.arange(nb), threads)
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            list(pool.map(
                lambda idx: native.enc_study(
                    blocks[idx[0]: idx[-1] + 1],
                    lens[idx[0]: idx[-1] + 1],
                    dst[idx[0]: idx[-1] + 1],
                    out_lens[idx[0]: idx[-1] + 1], variant),
                chunks))
            return time.perf_counter() - t0

    results = {}
    for variant in (0, 1, 2, 3):
        for threads in (1, args.threads):
            best = min(run(variant, threads) for _ in range(args.repeats))
            gbs = total / 1e9 / best
            results[(variant, threads)] = gbs
            print(f"variant {variant} ({names[variant]:14s}) x{threads}: "
                  f"{gbs:.3f} GB/s  ({best*1e6/nb:.1f} us/block)")

    # production entry for comparison (sn_compress via compress_batch)
    clens64 = np.zeros(nb, np.int64)
    hdrs64 = np.zeros(nb, np.int64)
    rc64 = np.zeros(nb, np.int64)
    for threads in (1, args.threads):
        best = None
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            native.compress_batch(blocks, lens, dst, clens64, hdrs64,
                                  rc64, n_threads=threads)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        print(f"production compress_batch x{threads}: "
              f"{total / 1e9 / best:.3f} GB/s")

    # instrumented pass: attribute the budget
    stats = np.zeros(8, np.uint64)
    native.enc_study(blocks, lens, dst, out_lens, 9, stats)
    probes, copies, copy_b, lits, lit_b, ext = (
        int(stats[0]), int(stats[1]), int(stats[2]), int(stats[3]),
        int(stats[4]), int(stats[5]))
    t1 = results[(0, 1)]
    ns_per_byte = 1.0 / t1  # ns/byte at baseline single-thread
    ghz = 3.0
    print(f"\nper-byte work items over {total >> 20} MB "
          f"(baseline {t1:.3f} GB/s = {ns_per_byte:.2f} ns/B "
          f"~ {ns_per_byte * ghz:.1f} cyc/B @3GHz):")
    print(f"  probes      {probes:>12,}  ({probes / total:.3f}/B)")
    print(f"  copies      {copies:>12,}  ({copy_b / total:.3f} B/B "
          f"covered)")
    print(f"  literals    {lits:>12,}  ({lit_b / total:.3f} B/B)")
    print(f"  ext steps   {ext:>12,}  ({ext / total:.3f}/B)")
    emit_cost = results[(0, 1)]
    noemit = results[(1, 1)]
    print(f"\nemission share (no-emit vs baseline): "
          f"{(1 - emit_cost / noemit) * 100:.1f}% of time")
    print(f"epoch-table vs baseline: "
          f"{(results[(2, 1)] / emit_cost - 1) * 100:+.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
