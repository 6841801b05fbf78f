"""Device block-encoder tests (CPU backend): wire-format validity via the
zlib oracle, block joins, batch API fault isolation, per-block checksums."""

import zlib

import numpy as np
import pytest

from libdeflate_rsx_tpu.batch import BatchCompressor, BatchDecompressor
from libdeflate_rsx_tpu.models.greedy_static import deflate_device_static
from libdeflate_rsx_tpu.models.stored import deflate_device_stored
from tests.conftest import make_corpus


def raw_inflate(b):
    return zlib.decompress(b, wbits=-15)


@pytest.mark.parametrize("kind,size", [
    ("text", 1000), ("text", 70000), ("pattern", 150000), ("zeros", 100000),
    ("random", 30000), ("text", 0), ("text", 1), ("periodic:7", 50000),
    ("text", 65536), ("text", 65537),
])
def test_device_static_roundtrip(kind, size):
    data = make_corpus(kind, size)
    comp = deflate_device_static(data)
    assert raw_inflate(comp) == data


def test_device_static_compresses():
    data = make_corpus("pattern", 100000)
    comp = deflate_device_static(data)
    assert len(comp) < len(data) // 10


@pytest.mark.parametrize("size", [0, 1, 100, 65535, 65536, 200000])
def test_device_stored_roundtrip(size):
    data = make_corpus("random", size)
    comp = deflate_device_stored(data)
    assert raw_inflate(comp) == data
    # stored overhead is exactly 5 bytes per 65535-byte block
    import libdeflate_rsx_tpu.models.stored as st
    nblocks = max(1, -(-size // st.STORED_BLOCK))
    assert len(comp) == size + 5 * nblocks


@pytest.mark.parametrize("fmt", ["deflate", "zlib", "gzip"])
@pytest.mark.parametrize("level", [0, 1, 6])
def test_batch_roundtrip(fmt, level):
    inputs = [make_corpus("text", n, seed=n) for n in (0, 1, 500, 40000)]
    bc = BatchCompressor(level=level, format=fmt)
    comp = bc.compress_batch(inputs)
    bd = BatchDecompressor(format=fmt)
    out = bd.decompress_batch(comp, [len(x) + 64 for x in inputs])
    assert out == inputs
    # interop: zlib must decode the container formats directly
    if fmt == "zlib":
        for c, d in zip(comp, inputs):
            assert zlib.decompress(c) == d
    if fmt == "gzip":
        import gzip
        for c, d in zip(comp, inputs):
            assert gzip.decompress(c) == d


def test_batch_item_fault_isolation():
    bd = BatchDecompressor(format="zlib")
    good = zlib.compress(b"hello world")
    out = bd.decompress_batch([good, b"\x00\x01garbage", good],
                              [64, 64, 64])
    assert out[0] == b"hello world"
    assert out[1] is None
    assert out[2] == b"hello world"


def test_batch_empty():
    assert BatchCompressor().compress_batch([]) == []
    assert BatchDecompressor().decompress_batch([], []) == []


def test_batch_undersized_output():
    bd = BatchDecompressor(format="deflate")
    comp = zlib.compress(b"A" * 1000)[2:-4]
    out = bd.decompress_batch([comp], [10])
    assert out == [None]


def test_blocks_checksums_traced_lengths():
    import jax.numpy as jnp
    from libdeflate_rsx_tpu.ops.checksums import adler32_blocks, crc32_blocks

    rows, s = 5, 4096
    rng = np.random.default_rng(7)
    data = np.zeros((rows, s), np.uint8)
    lengths = np.array([0, 1, 1000, 4095, 4096], np.int32)
    for i, ln in enumerate(lengths):
        data[i, :ln] = rng.integers(0, 256, ln)
    crcs = np.asarray(crc32_blocks(jnp.asarray(data), jnp.asarray(lengths)))
    adlers = np.asarray(adler32_blocks(jnp.asarray(data), jnp.asarray(lengths)))
    for i, ln in enumerate(lengths):
        raw = data[i, :ln].tobytes()
        assert int(crcs[i]) == zlib.crc32(raw), (i, ln)
        assert int(adlers[i]) == zlib.adler32(raw), (i, ln)


def test_unrolled_launch_path_roundtrip():
    """The chunked launch pipeline (jit_encoder_scan, used for large
    buffers and by bench.py) must produce the same valid streams as the
    single-launch path."""
    import zlib

    from libdeflate_rsx_tpu.models.greedy_static import (
        deflate_device_static)

    data = make_corpus("pattern", 40 * 16384 + 123)
    comp = deflate_device_static(data, block_size=16384, launch_rows=4)
    assert zlib.decompress(comp, wbits=-15) == data
