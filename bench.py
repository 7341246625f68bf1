#!/usr/bin/env python
"""Benchmark entry point: prints ONE JSON line.

Runs the framed codec over the synthetic Silesia-like corpus through
snappy_tpu.bench.harness.run_bench and reports decompress GB/s/chip as
the headline (the id path's system phase), with end-to-end, compress,
ratio-parity and long-stream fields alongside.  vs_baseline is
value / 20 GB/s (the BASELINE decompress target).

A measurement that finds no GPU fails: there is no CPU fallback.  The
card's name and power limit (nvidia-smi) are printed to stderr and
carried in the JSON, beside the device as JAX reports it.

Usage: python bench.py   (env: SNAPPY_TPU_BENCH_BYTES, _REPEATS, ...)
"""

import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _ROOT)


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as it prints it (a
    child process that stays off JAX); one line per card."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU found (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    card = gpu_name_and_power_limit()
    print(f"[bench] card: {card}", file=sys.stderr, flush=True)

    from snappy_tpu.bench.harness import run_bench

    size = int(os.environ.get("SNAPPY_TPU_BENCH_BYTES", str(32 << 20)))
    repeats = int(os.environ.get("SNAPPY_TPU_BENCH_REPEATS", "2"))
    result = run_bench(size=size, repeats=repeats)
    result["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    result["card"] = card
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
