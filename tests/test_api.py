"""Public API + backend registry: the swappable-command-var seam
(SURVEY.md §2.2 test discipline -> backend registry)."""

import pytest

from snappy_tpu import api
from snappy_tpu.errors import SnappyError


def test_available_backends_complete():
    names = api.available_backends()
    for want in ("oracle", "np", "jnp"):
        assert want in names, names


def test_unknown_backend_raises():
    with pytest.raises((SnappyError, KeyError, ValueError)):
        api.compress(b"x", backend="definitely-not-a-backend")


def test_env_backend_selection(monkeypatch, rng):
    monkeypatch.setenv("SNAPPY_TPU_BACKEND", "oracle")
    data = rng.randbytes(2000)
    c = api.compress(data)  # backend=None -> env
    assert api.decompress(c) == data


def test_register_custom_backend(rng):
    calls = []

    def fake_compress(data):
        calls.append(len(data))
        from snappy_tpu.spec import reference

        return reference.compress(data)

    api.register_backend("test-custom", compress=fake_compress)
    try:
        data = rng.randbytes(500)
        c = api.compress(data, backend="test-custom")
        assert calls == [500]
        assert api.decompress(c, backend="oracle") == data
        # ops not provided by the custom backend fail loudly
        with pytest.raises((SnappyError, KeyError, ValueError, AttributeError)):
            api.decompress(c, backend="test-custom")
    finally:
        api._BACKENDS.pop("test-custom", None)


def test_cross_backend_matrix(rng):
    """Every backend's framed output decodes on every other backend."""
    data = (b"matrix " * 500)[:3000] + rng.randbytes(1000)
    backends = [b for b in ("oracle", "np", "native") if b in api.available_backends()]
    blobs = {b: api.compress_framed(data, backend=b) for b in backends}
    for src, blob in blobs.items():
        for dst in backends:
            assert api.decompress_framed(blob, backend=dst) == data, (src, dst)


def test_into_entry_points(rng):
    """api.decompress_into / decompress_framed_into: the reused-buffer
    production path — parity with the allocating entries, bounds
    checked, and present even without the native lib (fallback)."""
    import numpy as np

    from snappy_tpu import api

    data = (b"api into " * 5000 + rng.randbytes(20_000))[:60_000]
    raw = api.compress(data, backend="np")
    fr = api.compress_framed(data, backend="np")
    out = np.empty(len(data) + 7, np.uint8)
    assert api.decompress_into(raw, out) == len(data)
    assert out[: len(data)].tobytes() == data
    out[:] = 0
    assert api.decompress_framed_into(fr, out) == len(data)
    assert out[: len(data)].tobytes() == data
    import pytest

    with pytest.raises(Exception):
        api.decompress_into(raw, np.empty(5, np.uint8))


def test_jnp_import_failure_surfaces(monkeypatch):
    """A device codec that cannot import must fail the call, not leave
    "auto" or backend="jnp" callers silently on another path."""
    import sys

    import snappy_tpu.runtime
    import snappy_tpu.runtime.device_codec  # noqa: F401

    monkeypatch.setattr(api, "_BACKENDS", {})
    monkeypatch.delattr(snappy_tpu.runtime, "device_codec")
    monkeypatch.setitem(sys.modules, "snappy_tpu.runtime.device_codec", None)
    with pytest.raises(ImportError):
        api.compress_framed(b"x", backend="jnp")
    with pytest.raises(ImportError):
        api.compress_framed(b"x")
