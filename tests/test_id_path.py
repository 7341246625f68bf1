"""The id division of labour on whatever platform JAX runs on: with the
native library present, every entry point takes the id path with no
monkeypatching — compress_framed byte-identical to the native codec and
decodable by the pure-Python oracle, decompress_framed and
decompress_framed_to_device round-tripping, over the shared corpus
samples (8 sizes x 5 compressibility families)."""

import random

import numpy as np
import pytest

from conftest import make_corpus_samples
from snappy_tpu import native
from snappy_tpu.runtime import device_codec
from snappy_tpu.spec import framing

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable")

_FAMILIES = ("random", "text", "rle", "words", "periodic")
_SIZES = (0, 1, 17, 18, 64, 1000, 65536, 70000)
_CASES = [(n, fam) for n in _SIZES for fam in _FAMILIES]
_SAMPLES: list = []


def _sample(k: int) -> bytes:
    if not _SAMPLES:  # same generator and seed as the conftest rng
        _SAMPLES.extend(make_corpus_samples(random.Random(1234)))
    return _SAMPLES[k]


def test_id_path_selected_without_patching():
    assert device_codec._use_id()


@pytest.mark.parametrize("k", range(len(_CASES)),
                         ids=[f"{n}-{fam}" for n, fam in _CASES])
def test_id_path_roundtrip(k):
    data = _sample(k)
    assert len(data) <= _CASES[k][0]  # "words" may run short
    fr = device_codec.compress_framed(data)
    assert fr == native.compress_framed(data)
    assert framing.decompress_framed(fr) == data
    assert device_codec.decompress_framed(fr) == data
    dev = device_codec.decompress_framed_to_device(fr)
    assert dev.shape == (len(data),)
    assert np.asarray(dev).tobytes() == data
