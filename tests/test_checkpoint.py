"""Array checkpointing over the device-resident codec (save = device CRC
before bytes leave HBM; load = bytes land device-resident, CRC
verified where they land).  The stream stays a spec-valid framed
stream — the manifest rides a skippable chunk any foreign decoder
ignores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

native = pytest.importorskip("snappy_tpu.native")
if not native.available():  # pragma: no cover
    pytest.skip("native library unavailable", allow_module_level=True)

from snappy_tpu import checkpoint  # noqa: E402
from snappy_tpu.errors import ChecksumError, CorruptError  # noqa: E402
from snappy_tpu.runtime import device_codec  # noqa: E402


@pytest.mark.parametrize("dtype,shape", [
    (jnp.float32, (1000, 33)),
    (jnp.bfloat16, (64, 129)),
    (jnp.int32, (70_001,)),
    (jnp.uint8, (200_000,)),
    (jnp.int8, (4097,)),
    (jnp.bool_, (513,)),
    (jnp.float32, (0,)),
])
def test_roundtrip_dtypes(rng, dtype, shape):
    n = int(np.prod(shape, dtype=np.int64))
    if dtype == jnp.bool_:
        host = (np.frombuffer(rng.randbytes(n), np.uint8)
                .reshape(shape) % 2 == 0)
    elif dtype in (jnp.float32, jnp.bfloat16):
        host = np.arange(n, dtype=np.float32).reshape(shape)
    else:  # integer dtypes: random bytes reinterpreted
        raw = np.frombuffer(rng.randbytes(max(n * 4, 4)), np.int32)[:n]
        host = raw.reshape(shape)
    arr = jax.device_put(jnp.asarray(host, dtype=dtype))
    blob = checkpoint.save_array(arr)
    back = checkpoint.load_array(blob)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    assert jnp.array_equal(back, arr), (dtype, shape)
    host_back = checkpoint.load_array(blob, to_device=False)
    assert np.array_equal(np.asarray(arr), host_back)


def test_stream_is_foreign_valid(rng):
    """A checkpoint IS a valid framed stream: decompress_framed skips
    the manifest chunk and yields the raw array bytes."""
    host = np.frombuffer(rng.randbytes(70_000), np.uint8)
    blob = checkpoint.save_array(jax.device_put(host))
    assert device_codec.decompress_framed(blob) == host.tobytes()


def test_corruption_detected(rng):
    host = np.arange(100_000, dtype=np.float32)
    blob = bytearray(checkpoint.save_array(jax.device_put(host)))
    blob[200] ^= 0xFF  # payload byte
    with pytest.raises((ChecksumError, CorruptError)):
        checkpoint.load_array(bytes(blob))
    with pytest.raises(CorruptError):
        checkpoint.load_array(b"\xff\x06\x00\x00sNaPpY")  # no manifest


def test_pytree_container(rng):
    tree = {
        "w": jax.device_put(np.arange(5000, dtype=np.float32)),
        "b": jax.device_put(np.frombuffer(rng.randbytes(64), np.uint8)),
        "step": jax.device_put(np.array([7], np.int32)),
    }
    blob = checkpoint.save_pytree(tree)
    back = checkpoint.load_pytree(blob)
    assert sorted(back) == sorted(tree)
    for k in tree:
        assert jnp.array_equal(back[k], tree[k]), k
    with pytest.raises(CorruptError):
        checkpoint.load_pytree(blob + b"x")
    with pytest.raises(CorruptError):
        checkpoint.load_pytree(b"NOTACKPT" + blob[8:])


def test_sharded_array_roundtrip(rng):
    """A mesh-sharded array saves and loads correctly (the save path
    slices batches; XLA gathers shards as needed — correctness here,
    the zero-gather mesh form is sharded_encode_rows_to_chunks)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from snappy_tpu.dist import mesh as dmesh

    mesh = dmesh.make_mesh()
    host = np.arange(8 * 40_000, dtype=np.float32)
    arr = jax.device_put(
        host.reshape(8, 40_000),
        NamedSharding(mesh, P("d")))
    blob = checkpoint.save_array(arr)
    back = checkpoint.load_array(blob)
    assert back.shape == (8, 40_000) and back.dtype == jnp.float32
    assert np.array_equal(np.asarray(back), host.reshape(8, 40_000))
