"""Device (JAX) checksum kernels vs the zlib oracle.

Runs on the CPU backend in tests (conftest forces JAX_PLATFORMS=cpu); the
same code runs as matrix products on a GPU, at Precision.HIGHEST.
Exactness does not depend on the backend:
the CRC matmul accumulates 0/1 values and the Adler matmuls stay below the
f32 integer-exactness bound.
"""

import zlib

import pytest

from libdeflate_rsx_tpu.ops.checksums import adler32_device, crc32_device
from tests.conftest import make_corpus

SIZES = [1, 2, 127, 128, 129, 1023, 1024, 1025, 4096, 5000, 65536, 100001,
         1 << 20]


@pytest.mark.parametrize("size", SIZES)
def test_crc32_device(size):
    data = make_corpus("random", size)
    assert crc32_device(data) == zlib.crc32(data)


@pytest.mark.parametrize("size", SIZES)
def test_adler32_device(size):
    data = make_corpus("random", size)
    assert adler32_device(data) == zlib.adler32(data)


def test_crc32_device_init_value():
    a = make_corpus("text", 3000)
    b = make_corpus("text", 5000, seed=9)
    assert crc32_device(b, crc=zlib.crc32(a)) == zlib.crc32(a + b)


def test_adler32_device_init_value():
    a = make_corpus("text", 3000)
    b = make_corpus("text", 5000, seed=9)
    assert adler32_device(b, adler=zlib.adler32(a)) == zlib.adler32(a + b)


def test_device_checksums_odd_chunk_counts():
    # 3, 5, 7 chunks exercise the odd-level zero-register fold path
    for chunks in (3, 5, 7, 9):
        data = make_corpus("random", 1024 * chunks, seed=chunks)
        assert crc32_device(data) == zlib.crc32(data)


def test_empty():
    assert crc32_device(b"") == 0
    assert adler32_device(b"") == 1
    assert crc32_device(b"", crc=123) == 123
