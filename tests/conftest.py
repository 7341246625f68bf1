"""Test harness configuration.

All jax-based tests run on a virtual 8-device CPU mesh (the reference
tested dual-rootfs hardware by mocking lsblk — SURVEY.md §4; we test
multi-chip sharding by faking an 8-chip host the same way).  These env
vars must be set before jax is first imported anywhere in the process.
"""

import os
import random
import sys

# Force CPU with a virtual 8-device mesh, whatever JAX_PLATFORMS says:
# the config override works as long as no backend has initialized yet.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Small device batches keep CPU test compiles fast (the runtime default
# is 64 blocks per call).
os.environ.setdefault("SNAPPY_TPU_BATCH", "8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Persistent XLA compilation cache: the kernel graphs are big and CPU
# compiles are slow; cache hits make repeat test runs fast.
from snappy_tpu.utils.jaxcache import setup_compilation_cache

setup_compilation_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return random.Random(1234)


@pytest.fixture
def nprng():
    return np.random.default_rng(1234)


def make_corpus_samples(rng: random.Random, sizes=(0, 1, 17, 18, 64, 1000, 65536, 70000)):
    """A spread of compressibility profiles at each size (hermetic,
    deterministic — the reference's makeTestSnapPackage-style fixtures)."""
    words = [
        bytes(rng.choices(b"abcdefgh ", k=rng.randint(2, 9))) for _ in range(50)
    ]
    out = []
    for n in sizes:
        out.append(bytes(rng.randbytes(n)))  # incompressible
        out.append((b"the quick brown fox. " * (n // 21 + 1))[:n])  # periodic text
        out.append(b"A" * n)  # RLE
        out.append(b"".join(rng.choice(words) for _ in range(n // 4 + 1))[:n])  # texty
        unit = rng.randbytes(rng.randint(1, 97) or 1)
        out.append((unit * (n // len(unit) + 2))[:n])  # periodic binary
    return out


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (multi-process parity sweeps)")
