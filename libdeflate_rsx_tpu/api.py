"""Public one-shot compression/decompression API (L1).

Mirrors the reference API surface (reference src/api.rs): `Compressor` with
levels 0..=12 and allocating + `_into` variants for deflate/zlib/gzip;
`Decompressor` with zip-bomb guards (`set_max_memory_limit`,
`set_limit_ratio`, default ratio 2000:1 + 4096 slack) and overlap rejection;
`*_compress_bound` functions.

The host engine backs these one-shot calls; the device batch path (batch.py,
models/) is the throughput-oriented entry and shares this framing layer.
"""

from __future__ import annotations

from . import containers
from .common import (
    DEFAULT_LIMIT_RATIO,
    DEFAULT_LIMIT_SLACK,
    MAX_LEVEL,
    MIN_LEVEL,
    deflate_compress_bound,
    gzip_compress_bound,
    zlib_compress_bound,
)
from .engine import adler32 as adler32_host
from .engine import compress_raw
from .engine import crc32 as crc32_host
from .engine import decompress_raw
from .models.portable.deflate import Flush
from .utils.errors import (
    BadDataError,
    DecompressStatus,
    InsufficientSpaceError,
    LevelError,
    LimitExceededError,
    OverlapError,
    ShortInputError,
)

__all__ = [
    "Compressor",
    "Decompressor",
    "deflate_compress_bound",
    "zlib_compress_bound",
    "gzip_compress_bound",
]


def _check_overlap(src, dst) -> None:
    """Reject aliasing input/output buffers for the `_into` variants
    (reference src/api.rs:303-314)."""
    import numpy as np
    try:
        a = np.frombuffer(src, dtype=np.uint8)
        b = np.frombuffer(dst, dtype=np.uint8)
    except (TypeError, ValueError):
        return
    if a.size == 0 or b.size == 0:
        return
    s0 = a.__array_interface__["data"][0]
    d0 = b.__array_interface__["data"][0]
    if s0 < d0 + b.size and d0 < s0 + a.size:
        raise OverlapError("input and output buffers overlap")


class Compressor:
    """One-shot compressor for raw DEFLATE, zlib, and gzip."""

    def __init__(self, level: int = 6) -> None:
        if not (MIN_LEVEL <= level <= MAX_LEVEL):
            raise LevelError(f"compression level {level} outside 0..=12")
        self.level = level

    # -- allocating variants -------------------------------------------------

    def compress_deflate(self, data: bytes) -> bytes:
        return compress_raw(bytes(data), self.level, Flush.FINISH)

    def compress_zlib(self, data: bytes) -> bytes:
        data = bytes(data)
        return (containers.zlib_header(self.level)
                + compress_raw(data, self.level, Flush.FINISH)
                + containers.zlib_footer(adler32_host(data)))

    def compress_gzip(self, data: bytes) -> bytes:
        data = bytes(data)
        return (containers.gzip_header(self.level)
                + compress_raw(data, self.level, Flush.FINISH)
                + containers.gzip_footer(crc32_host(data), len(data)))

    # -- caller-buffer variants ----------------------------------------------

    def _into(self, fn, data, out) -> int:
        _check_overlap(data, out)
        result = fn(bytes(data))
        if len(result) > len(out):
            raise InsufficientSpaceError(
                f"output buffer too small: need {len(result)}, have {len(out)}")
        out[: len(result)] = result
        return len(result)

    def compress_to_size(self, data: bytes) -> int:
        """Exact compressed size for `data` at this level without
        returning the stream (the reference's compress_to_size estimator,
        reference src/compress/mod.rs:1073-1094 — here exact)."""
        return len(self.compress_deflate(data))

    def compress_deflate_into(self, data, out) -> int:
        return self._into(self.compress_deflate, data, out)

    def compress_zlib_into(self, data, out) -> int:
        return self._into(self.compress_zlib, data, out)

    def compress_gzip_into(self, data, out) -> int:
        return self._into(self.compress_gzip, data, out)


class Decompressor:
    """One-shot decompressor with zip-bomb guards."""

    def __init__(self) -> None:
        self._max_memory: int | None = None
        self._limit_ratio: int = DEFAULT_LIMIT_RATIO

    def set_max_memory_limit(self, nbytes: int | None) -> None:
        """Absolute cap on the allocated output size (None = unlimited)."""
        self._max_memory = nbytes

    def set_limit_ratio(self, ratio: int) -> None:
        """Max expansion ratio vs compressed size (default 2000:1 + 4096)."""
        self._limit_ratio = ratio

    def _check_limits(self, in_size: int, out_size: int) -> None:
        if self._max_memory is not None and out_size > self._max_memory:
            raise LimitExceededError(
                f"output size {out_size} exceeds memory limit {self._max_memory}")
        if self._limit_ratio and out_size > in_size * self._limit_ratio + DEFAULT_LIMIT_SLACK:
            raise LimitExceededError(
                f"expansion ratio guard tripped: {in_size} -> {out_size}")

    def _inflate(self, payload: bytes, max_out: int):
        return decompress_raw(payload, max_out)

    # -- raw deflate ---------------------------------------------------------

    def decompress_deflate(self, data: bytes, max_out: int) -> bytes:
        data = bytes(data)
        self._check_limits(len(data), max_out)
        out, _ = self._inflate(data, max_out)
        return out

    def decompress_zlib(self, data: bytes, max_out: int) -> bytes:
        data = bytes(data)
        self._check_limits(len(data), max_out)
        start = containers.parse_zlib_header(data)
        out, consumed = self._inflate(data[start:], max_out)
        containers.verify_zlib_footer(data[start + consumed:], adler32_host(out))
        return out

    def decompress_gzip(self, data: bytes, max_out: int) -> bytes:
        data = bytes(data)
        self._check_limits(len(data), max_out)
        start = containers.parse_gzip_header(data)
        out, consumed = self._inflate(data[start:], max_out)
        containers.verify_gzip_footer(data[start + consumed:],
                                      crc32_host(out), len(out))
        return out

    # -- caller-buffer variants ----------------------------------------------

    def _into(self, fn, data, out) -> int:
        _check_overlap(data, out)
        result = fn(bytes(data), len(out))
        out[: len(result)] = result
        return len(result)

    def decompress_deflate_into(self, data, out) -> int:
        return self._into(self.decompress_deflate, data, out)

    def decompress_zlib_into(self, data, out) -> int:
        return self._into(self.decompress_zlib, data, out)

    def decompress_gzip_into(self, data, out) -> int:
        return self._into(self.decompress_gzip, data, out)
