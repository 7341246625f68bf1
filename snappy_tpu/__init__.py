"""snappy_tpu — a Snappy codec framework for accelerators, in JAX.

Layers (SURVEY.md §7.1):
  spec/     L0 pure-Python oracle codec + format constants
  kernels/  L1 jnp device kernels (parallel decode/encode, CRC)
  runtime/  L2 block planner, padded buffers, framed-format production path
  dist/     L3 device-mesh sharding (DP over independent 64 KiB blocks)
  native/   L7 C++ host codec + hardware CRC-32C (ctypes bindings)
  cli/      L5 `tpusnappy` command-line tool

Public API (L4): compress / decompress (raw block format),
compress_framed / decompress_framed (.sz framed format), and the
device-resident matrix decompress_to_device /
decompress_framed_to_device (decode-to-HBM data loading) and
compress_from_device / compress_framed_from_device (HBM array ->
stream; the framed form computes per-chunk CRC-32C on the device).
"""

from snappy_tpu.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    SnappyError,
    TooLargeError,
    UnsupportedError,
)

__version__ = "0.5.0"

__all__ = [
    "SnappyError",
    "CorruptError",
    "ChecksumError",
    "TooLargeError",
    "UnsupportedError",
    "BadMagicError",
    "compress",
    "decompress",
    "compress_framed",
    "decompress_framed",
    "decompress_into",
    "decompress_framed_into",
    "decompress_to_device",
    "decompress_framed_to_device",
    "compress_framed_from_device",
    "compress_from_device",
    "__version__",
]


def __getattr__(name):
    # Lazy imports keep `import snappy_tpu` cheap and jax-free until a
    # codec entry point is actually used.
    if name in ("compress", "decompress", "compress_framed",
                "decompress_framed", "decompress_into",
                "decompress_framed_into", "decompress_to_device",
                "decompress_framed_to_device",
                "compress_framed_from_device",
                "compress_from_device"):
        from snappy_tpu import api

        return getattr(api, name)
    if name in ("FramedReader", "FramedWriter"):
        from snappy_tpu.runtime import stream

        return getattr(stream, name)
    if name == "checkpoint":
        import importlib

        return importlib.import_module("snappy_tpu.checkpoint")
    raise AttributeError(f"module 'snappy_tpu' has no attribute {name!r}")
