"""L4 public API: bytes-in/bytes-out codec entry points.

Backend dispatch follows the reference's swappable-command-var test seam
(SURVEY.md §4.1): every entry point routes through a registry of
interchangeable backends ("oracle" pure-Python, "np" numpy, "native"
C++, "jnp" the device codec), selectable per call or via
SNAPPY_TPU_BACKEND.  All backends are bit-compatible on decode and
validated against the oracle.
"""

from __future__ import annotations

import os
from typing import Callable

_BACKENDS: dict[str, dict[str, Callable]] = {}


def register_backend(name: str, **fns: Callable) -> None:
    _BACKENDS.setdefault(name, {}).update(fns)


def available_backends() -> list[str]:
    _ensure_default_backends()
    return sorted(_BACKENDS)


def _ensure_default_backends() -> None:
    if "oracle" not in _BACKENDS:
        from snappy_tpu.spec import framing, reference

        register_backend(
            "oracle",
            compress=reference.compress,
            decompress=reference.decompress,
            compress_framed=framing.compress_framed,
            decompress_framed=framing.decompress_framed,
        )
    if "np" not in _BACKENDS:
        from snappy_tpu.kernels import encode_np
        from snappy_tpu.spec import framing, reference

        register_backend(
            "np",
            compress=encode_np.compress,
            decompress=reference.decompress,
            compress_framed=lambda data, **kw: framing.compress_framed(data, **kw),
            decompress_framed=framing.decompress_framed,
        )
    if "native" not in _BACKENDS:
        try:
            from snappy_tpu import native

            if native.available():
                register_backend(
                    "native",
                    compress=native.compress,
                    decompress=native.decompress,
                    compress_framed=native.compress_framed,
                    decompress_framed=native.decompress_framed,
                )
        except Exception:  # pragma: no cover - native build is optional
            pass
    if "jnp" not in _BACKENDS:
        # no guard: a broken device codec must fail loudly, not leave
        # "auto" and explicit backend="jnp" callers on another path
        from snappy_tpu.runtime import device_codec

        register_backend(
            "jnp",
            compress=device_codec.compress,
            decompress=device_codec.decompress,
            compress_framed=device_codec.compress_framed,
            decompress_framed=device_codec.decompress_framed,
        )


_PREFERENCE = ("native", "oracle")


def _resolve(op: str, backend: str | None) -> Callable:
    _ensure_default_backends()
    name = backend or os.environ.get("SNAPPY_TPU_BACKEND") or "auto"
    if name != "auto":
        try:
            return _BACKENDS[name][op]
        except KeyError:
            raise ValueError(
                f"backend {name!r} does not provide {op!r}; available: "
                f"{sorted(b for b, ops in _BACKENDS.items() if op in ops)}"
            ) from None
    for cand in _PREFERENCE:
        if cand in _BACKENDS and op in _BACKENDS[cand]:
            return _BACKENDS[cand][op]
    raise RuntimeError(f"no backend provides {op!r}")


def compress(data: bytes, *, backend: str | None = None) -> bytes:
    """Compress bytes into the raw Snappy block format."""
    return _resolve("compress", backend)(data)


def decompress(data: bytes, *, backend: str | None = None) -> bytes:
    """Decompress a raw Snappy block-format stream."""
    return _resolve("decompress", backend)(data)


def compress_framed(data: bytes, *, backend: str | None = None) -> bytes:
    """Compress bytes into the framed (.sz) stream format."""
    return _resolve("compress_framed", backend)(data)


def decompress_framed(data: bytes, *, backend: str | None = None) -> bytes:
    """Decompress a framed (.sz) stream."""
    return _resolve("decompress_framed", backend)(data)


def decompress_into(data: bytes, out) -> int:
    """Decompress a raw Snappy stream into a CALLER-OWNED uint8 numpy
    buffer; returns the decoded length.  The zero-allocation
    production path (a fresh multi-GB output pays ~60 us/page in
    first-touch faults on some hosts; pipelines reuse buffers).
    Portable: routes to the native decoder when present, else decodes
    and copies."""
    import numpy as np

    try:
        from snappy_tpu import native

        if native.available():
            return native.decompress_into(data, out)
    except ImportError:  # pragma: no cover
        pass
    blob = decompress(data)
    if out.size < len(blob):
        raise ValueError(f"out buffer {out.size} < decoded {len(blob)}")
    out[: len(blob)] = np.frombuffer(blob, np.uint8)
    return len(blob)


def decompress_framed_into(data: bytes, out,
                           verify_checksums: bool = True) -> int:
    """Decompress a framed (.sz) stream into a CALLER-OWNED uint8
    numpy buffer; returns the decoded length (see decompress_into)."""
    import numpy as np

    try:
        from snappy_tpu import native

        if native.available():
            return native.decompress_framed_into(
                data, out, verify_checksums=verify_checksums)
    except ImportError:  # pragma: no cover
        pass
    blob = decompress_framed(data)
    if out.size < len(blob):
        raise ValueError(f"out buffer {out.size} < decoded {len(blob)}")
    out[: len(blob)] = np.frombuffer(blob, np.uint8)
    return len(blob)


def decompress_to_device(data: bytes):
    """Decompress a raw Snappy stream to a DEVICE-RESIDENT uint8
    jax.Array (the decode-to-HBM data-loader path: H2D carries exactly
    the decompressed bytes, nothing crosses back to the host)."""
    from snappy_tpu.runtime import device_codec

    return device_codec.decompress_to_device(data)


def decompress_framed_to_device(data: bytes, verify_checksums: bool = True):
    """Decompress a framed (.sz) stream to a DEVICE-RESIDENT uint8
    jax.Array, per-chunk CRC-32C verified on the device where the bytes
    land; only the tiny err vector returns to the host."""
    from snappy_tpu.runtime import device_codec

    return device_codec.decompress_framed_to_device(data, verify_checksums)


def compress_framed_from_device(arr) -> bytes:
    """Compress a DEVICE-RESIDENT uint8 jax.Array into a framed (.sz)
    stream (the encode half of the data-loader path: per-chunk
    CRC-32C computed on the device before any byte leaves HBM; the D2H
    row fetch overlaps the threaded host matcher).  Byte-identical to
    compress_framed(bytes(arr))."""
    from snappy_tpu.runtime import device_codec

    return device_codec.compress_framed_from_device(arr)


def compress_from_device(arr) -> bytes:
    """Compress a DEVICE-RESIDENT uint8 jax.Array into a RAW Snappy
    stream.  The raw block format carries no checksums, so unlike the
    framed direction there is no device CRC to fuse — this is a D2H
    fetch feeding the threaded host encoder, provided so the
    to/from-device API matrix is complete in both formats (the framed
    form is the production from-device path).  Byte-identical to
    compress(bytes(arr))."""
    from snappy_tpu.runtime import device_codec

    return device_codec.compress_from_device(arr)
