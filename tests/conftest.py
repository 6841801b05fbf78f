"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

This replaces the reference's "multi-thread without a cluster" trick
(SURVEY.md §4): multi-device shard_map paths run against
xla_force_host_platform_device_count=8 CPU devices, and the pass-1
decoder kernel runs in the Pallas interpreter. Tests marked `gpu` skip
here; `python chip_smoke.py` runs their checks on a GPU.
"""

import os

# Set before jax is imported: unit tests must be hermetic and exercise
# the 8-device shard_map paths, even where a GPU is present.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache for the XLA compiles (device encode /
# resolve jits): JAX_COMPILATION_CACHE_DIR if set, else <repo>/.jax_cache.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), "..",
                                   ".jax_cache"))

import jax

jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import random

import numpy as np
import pytest


@pytest.fixture
def rng():
    return random.Random(0x5EED)


@pytest.fixture
def nprng():
    return np.random.default_rng(0x5EED)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a CUDA GPU (decided per test, never at
    import time, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run python chip_smoke.py on one)")


def make_corpus(kind: str, size: int, seed: int = 1234) -> bytes:
    """Deterministic test corpora in the spirit of the reference's
    gen_bench_files.py recipe (repeated ~100-byte pseudo-pattern), plus
    text-like, random, and periodic variants."""
    r = random.Random(seed)
    if kind == "pattern":
        base = bytes(r.randrange(256) for _ in range(100))
        reps = size // len(base) + 1
        return (base * reps)[:size]
    if kind == "text":
        words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over",
                 b"lazy", b"dog", b"compression", b"deflate", b"huffman",
                 b"gpu", b"kernel", b"stream"]
        out = bytearray()
        while len(out) < size:
            out += r.choice(words) + b" "
            if r.random() < 0.05:
                out += b"\n"
        return bytes(out[:size])
    if kind == "random":
        return bytes(r.randrange(256) for _ in range(size))
    if kind == "zeros":
        return b"\x00" * size
    if kind.startswith("periodic"):
        period = int(kind.split(":")[1])
        base = bytes(r.randrange(256) for _ in range(period))
        reps = size // period + 1
        return (base * reps)[:size]
    raise ValueError(kind)
