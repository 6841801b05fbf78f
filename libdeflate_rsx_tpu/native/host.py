"""Python bindings for the native host codec (native/codec.c).

Two bindings: the CPython C-extension (native/pymod.c, ~100 ns/call,
releases the GIL on large buffers — the host thread-pool layer depends
on that) for the hot calls, and ctypes for the bit-exact incremental
encoder and the resumable decoder. Both are built from the committed
sources on first use; a failed build raises (native/__init__.py).
Functions return None for inputs the C engine does not take (level 0,
errors other than the ones mapped to exceptions), and callers then use
the portable engine.
"""

from __future__ import annotations

import ctypes

from . import get_ext, get_lib
from ..utils.errors import (
    BadDataError,
    InsufficientSpaceError,
    ShortInputError,
)

_ERR_BADDATA = -1
_ERR_SPACE = -2
_ERR_SHORT = -3

_HASH_SIZE = 1 << 16

_FLUSH_SYNC = 1
_FLUSH_FINISH = 2


def native_deflate(data: bytes, level: int, flush: int,
                   history: bytes = b"") -> bytes | None:
    """Raw DEFLATE of `data` (with LZ history), levels 1-12.
    flush: 1 = SYNC, 2 = FINISH. None for other levels or on error."""
    if not (1 <= level <= 12):
        return None
    ext = get_ext()
    if history:
        out = ext.deflate(data, level, flush, history)
    else:
        out = ext.deflate(data, level, flush)
    if isinstance(out, int):
        if out == _ERR_SPACE:
            raise InsufficientSpaceError("compressed output exceeded bound")
        return None
    return out


def _map_inflate_err(n: int) -> None:
    if n == _ERR_BADDATA:
        raise BadDataError("invalid DEFLATE stream")
    if n == _ERR_SHORT:
        raise ShortInputError("compressed data truncated")
    if n == _ERR_SPACE:
        raise InsufficientSpaceError("decompressed data exceeds buffer")


def native_deflate_bits(data: bytes, level: int, mode: int,
                        history: bytes = b"", phase: int = 0):
    """Bit-exact raw DEFLATE for the incremental Deflater (the
    reference's FlushMode::None, reference src/compress/mod.rs:424-429):
    the stream starts at bit `phase` (0..7) of its first output byte and
    mode 0 (NONE) / 3 (FINISH-bits) return the total BIT length with no
    byte-alignment padding.

    Returns (out_array, total_bits_including_phase) — for modes 1/2 the
    bit count is 8 * byte count. None for other levels or on error."""
    if not (1 <= level <= 12):
        return None
    lib = get_lib()
    import numpy as np
    buf = history + data if history else data
    total = len(buf)
    cap = total + (total >> 3) + 4096
    out = np.zeros(cap, np.uint8)
    src = np.frombuffer(buf, np.uint8) if total else np.zeros(1, np.uint8)
    work = np.zeros(2 * _HASH_SIZE + total, np.int32)
    r = lib.deflate_c(src.ctypes.data, len(history), total, level,
                      mode | ((phase & 7) << 4), out.ctypes.data, cap,
                      work.ctypes.data)
    if r == _ERR_SPACE:
        raise InsufficientSpaceError("compressed output exceeded bound")
    if r < 0:
        return None
    bits = int(r) if mode in (0, 3) else int(r) * 8
    return out, bits


def native_inflate(data: bytes, max_out: int):
    """One-shot raw-DEFLATE decode. Returns (bytes, consumed), or None
    for an error the mapped exceptions do not cover."""
    res = get_ext().inflate(data, max_out)
    if isinstance(res, int):
        _map_inflate_err(res)
        return None
    return res


def native_crc32(data: bytes, crc: int = 0) -> int:
    return get_ext().crc32(data, crc)


def native_adler32(data: bytes, adler: int = 1) -> int:
    return get_ext().adler32(data, adler)


def native_resolve_tokens(tokens, out_cap: int) -> bytes | None:
    """Pass-2 LZ resolution of a device token column (ops/tokens.py
    format). Returns the decoded bytes, or None if the tokens are
    invalid."""
    return get_ext().resolve_tokens(tokens, out_cap)


class CInflater:
    """Native resumable streaming decoder (codec.c icx_*), presenting
    the same step() protocol as models/portable/inflate.Inflater so
    DeflateDecoder can use it for non-seekable readers at native speed."""

    def __init__(self) -> None:
        import numpy as np

        lib = get_lib()
        self._lib = lib
        self._ctx = np.zeros(int(lib.icx_size()), np.uint8)
        lib.icx_init(self._ctx.ctypes.data)
        self._done = False

    @property
    def finished(self) -> bool:
        return self._done

    def step(self, data: bytes, out: bytearray, max_out: int):
        """Consume from `data`, append to `out` (never past max_out
        total). Returns (DecompressStatus, bytes_consumed)."""
        import numpy as np

        from ..utils.errors import BadDataError, DecompressStatus

        room = max(max_out - len(out), 0)
        buf = np.empty(max(room, 1), np.uint8)
        src = np.frombuffer(data, np.uint8) if data else \
            np.zeros(1, np.uint8)
        in_used = ctypes.c_int64(0)
        out_written = ctypes.c_int64(0)
        rc = self._lib.icx_step(
            self._ctx.ctypes.data, src.ctypes.data, len(data),
            buf.ctypes.data, room,
            ctypes.byref(in_used), ctypes.byref(out_written))
        out += buf[: int(out_written.value)].tobytes()
        if rc < 0:
            raise BadDataError("invalid DEFLATE stream")
        if rc == 0:
            self._done = True
            return DecompressStatus.DONE, int(in_used.value)
        if rc == 2:
            return DecompressStatus.INSUFFICIENT_SPACE, int(in_used.value)
        return DecompressStatus.SHORT_INPUT, int(in_used.value)
