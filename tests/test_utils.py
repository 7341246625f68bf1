"""Utility subsystems: progress meters, logger, host memory tuning."""

import io
import logging

from snappy_tpu.utils.hostmem import tune_allocator
from snappy_tpu.utils.log import get_logger, log_error
from snappy_tpu.utils.progress import NullMeter, TextMeter, default_meter


def test_text_meter_output():
    buf = io.StringIO()
    m = TextMeter(stream=buf)
    m.start("compress", 1000)
    m.set(500)
    m.set(1000)
    m.finish()
    text = buf.getvalue()
    assert "compress" in text and "GB/s" in text and "100.0%" in text


def test_null_meter_noop():
    m = NullMeter()
    m.start("x", 10)
    m.set(5)
    m.finish()


def test_default_meter_non_tty():
    # pytest captures stderr (not a tty) -> NullMeter
    assert isinstance(default_meter(), (NullMeter, TextMeter))


def test_logger_levels(caplog):
    log = get_logger()
    with caplog.at_level(logging.DEBUG, logger="snappy_tpu"):
        log.info("hello %s", "world")
    assert any("hello world" in r.message for r in caplog.records)


def test_log_error_returns_same(caplog):
    err = ValueError("boom")
    with caplog.at_level(logging.ERROR, logger="snappy_tpu"):
        assert log_error(err, context="unit") is err
    assert any("boom" in str(r.getMessage()) for r in caplog.records)


def test_tune_allocator_idempotent():
    assert tune_allocator() in (True, False)
    tune_allocator()  # second call is a no-op


def test_text_meter_throttles_updates():
    buf = io.StringIO()
    m = TextMeter(stream=buf)
    m.start("t", 10_000)
    for i in range(100):
        m.set(i)  # sub-0.1s apart: most must be dropped
    assert buf.getvalue().count("\r") <= 3


def test_default_meter_tty(monkeypatch):
    from snappy_tpu.utils import progress

    monkeypatch.setattr(progress.os, "isatty", lambda fd: True)
    assert isinstance(progress.default_meter(), TextMeter)


def test_exit_code_contract():
    from snappy_tpu import errors

    assert errors.exit_code_for(errors.CorruptError("x")) == errors.EXIT_CORRUPT
    assert errors.exit_code_for(errors.ChecksumError(1, 2)) == errors.EXIT_CHECKSUM
    assert (
        errors.exit_code_for(errors.UnsupportedError(5)) == errors.EXIT_UNSUPPORTED
    )
    assert errors.exit_code_for(errors.TooLargeError(9)) == errors.EXIT_TOO_LARGE
    assert errors.exit_code_for(errors.BadMagicError()) == errors.EXIT_CORRUPT
    # unknown exceptions map to the generic failure code
    assert errors.exit_code_for(RuntimeError("?")) not in (0, None)


def test_warm_heap_smoke():
    from snappy_tpu.utils.hostmem import warm_heap

    warm_heap(1 << 20)  # must not raise; idempotent tuning inside


def test_jaxcache_honours_env(monkeypatch, tmp_path):
    from snappy_tpu.utils import jaxcache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.cache_dir() == str(tmp_path)


def test_jaxcache_default_is_fixed_in_repo(monkeypatch):
    import os

    from snappy_tpu.utils import jaxcache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxcache.cache_dir() == os.path.join(repo, ".jax_cache")
