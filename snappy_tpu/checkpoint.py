"""Array checkpointing over the device-resident codec paths.

The production use case the from/to-device APIs exist for
(docs/architecture.md: "the destination is the chip"): save a jax
array that lives in HBM as a compressed framed stream whose per-chunk
CRC-32C is computed on the device before any byte leaves it, and
load it back with the bytes landing device-resident and CRC-verified
where they land.

Format: a STANDARD framed (.sz) stream — any snappy framed decoder
recovers the raw array bytes — with one spec-legal SKIPPABLE chunk
(type 0x80, §8.2: foreign decoders must skip 0x80-0xFD) carrying the
dtype/shape manifest right after the stream identifier.  Integrity
follows the reference's manifest discipline (snappy/hashes.go: verify
before activate): load checks the manifest before decoding and every
chunk CRC on device.

Multi-array checkpoints use a tiny length-prefixed container
(save_pytree/load_pytree over a flat name->array mapping).
"""

from __future__ import annotations

import json
import struct

__all__ = [
    "save_array",
    "load_array",
    "save_pytree",
    "load_pytree",
    "CHUNK_META",
]

CHUNK_META = 0x80  # first skippable chunk id (spec §8.2)
_CONTAINER_MAGIC = b"SNPCKPT1"


def _meta_chunk(meta: dict) -> bytes:
    payload = json.dumps(meta, sort_keys=True).encode()
    n = len(payload)
    if n > 0xFFFFFF:  # pragma: no cover - manifests are tiny
        raise ValueError("manifest too large")
    return bytes((CHUNK_META, n & 0xFF, (n >> 8) & 0xFF,
                  (n >> 16) & 0xFF)) + payload


def _split_meta(data: bytes):
    """Return (meta dict or None, framed stream with the meta chunk
    still in place — decoders skip it)."""
    from snappy_tpu.spec.format import STREAM_ID_CHUNK

    pos = len(STREAM_ID_CHUNK)
    if data[:pos] != STREAM_ID_CHUNK or len(data) < pos + 4:
        return None, data
    if data[pos] != CHUNK_META:
        return None, data
    n = data[pos + 1] | (data[pos + 2] << 8) | (data[pos + 3] << 16)
    try:
        meta = json.loads(data[pos + 4:pos + 4 + n].decode())
    except Exception:
        return None, data
    return meta, data


def save_array(arr) -> bytes:
    """Serialize a device-resident jax array: bitcast to uint8 ON
    DEVICE, compress through compress_framed_from_device (device CRC
    before the bytes leave HBM), manifest in a skippable chunk."""
    import jax
    import jax.numpy as jnp

    from snappy_tpu.runtime.device_codec import compress_framed_from_device
    from snappy_tpu.spec.format import STREAM_ID_CHUNK

    arr = jnp.asarray(arr)
    meta = {"v": 1, "dtype": str(arr.dtype), "shape": list(arr.shape)}
    flat = arr.reshape(-1)
    if flat.dtype != jnp.uint8:
        if flat.dtype.itemsize > 1:
            flat = jax.lax.bitcast_convert_type(
                flat, jnp.uint8).reshape(-1)
        else:  # int8/bool: value-preserving 1-byte cast round-trips
            flat = flat.astype(jnp.uint8)
    fr = compress_framed_from_device(flat)
    head = len(STREAM_ID_CHUNK)
    return fr[:head] + _meta_chunk(meta) + fr[head:]


def load_array(data: bytes, to_device: bool = True):
    """Load an array saved by save_array.  to_device=True (default)
    lands the bytes device-resident via decompress_framed_to_device
    (CRC verified on the device) and bitcasts back on device; False
    decodes to host and returns a numpy array."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from snappy_tpu.errors import CorruptError
    from snappy_tpu.runtime.device_codec import (
        decompress_framed,
        decompress_framed_to_device,
    )

    meta, stream = _split_meta(data)
    if meta is None or meta.get("v") != 1:
        raise CorruptError("missing or unreadable checkpoint manifest")
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if not to_device:
        blob = decompress_framed(stream)
        if len(blob) != want:
            raise CorruptError("checkpoint size disagrees with manifest")
        return np.frombuffer(blob, dtype).reshape(shape).copy()
    u8 = decompress_framed_to_device(stream)
    if int(u8.shape[0]) != want:
        raise CorruptError("checkpoint size disagrees with manifest")
    if dtype.itemsize > 1:
        out = jax.lax.bitcast_convert_type(
            u8.reshape(-1, dtype.itemsize), jnp.dtype(dtype))
        return out.reshape(shape)
    return u8.astype(jnp.dtype(dtype)).reshape(shape)


def save_pytree(tree: dict) -> bytes:
    """Serialize a flat name->array mapping as one container (names
    sorted; each entry a self-contained save_array stream)."""
    out = bytearray(_CONTAINER_MAGIC)
    items = sorted(tree.items())
    out += struct.pack("<I", len(items))
    for name, arr in items:
        nb = name.encode()
        blob = save_array(arr)
        out += struct.pack("<I", len(nb)) + nb
        out += struct.pack("<Q", len(blob)) + blob
    return bytes(out)


def load_pytree(data: bytes, to_device: bool = True) -> dict:
    from snappy_tpu.errors import CorruptError

    if data[:8] != _CONTAINER_MAGIC:
        raise CorruptError("not a snappy_tpu checkpoint container")
    pos = 8
    (n,) = struct.unpack_from("<I", data, pos)
    pos += 4
    out = {}
    for _ in range(n):
        (nl,) = struct.unpack_from("<I", data, pos)
        pos += 4
        name = data[pos:pos + nl].decode()
        pos += nl
        (bl,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        out[name] = load_array(data[pos:pos + bl], to_device=to_device)
        pos += bl
    if pos != len(data):
        raise CorruptError("trailing bytes after checkpoint container")
    return out
