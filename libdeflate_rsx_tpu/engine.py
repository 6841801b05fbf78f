"""Host-engine dispatch: native C codec when available, pure-Python
reference engine otherwise.

The reference's host path is a single native implementation; this build
keeps two tiers — native/codec.c for speed, models/portable/ as the
bit-exact reference and fallback (also the streaming/resumable engine) —
selected here. Level 0 always uses the Python engine (stored blocks).
"""

from __future__ import annotations

from .models.portable.deflate import Flush, deflate_host
from .models.portable.inflate import Inflater
from .utils.errors import (
    DecompressStatus,
    InsufficientSpaceError,
    ShortInputError,
)

_FLUSH_CODE = {Flush.SYNC: 1, Flush.FINISH: 2}

# intra-buffer parallel chunking, the reference's >256 KiB scheme
# (reference src/compress/mod.rs:699-772) with history carried across
# chunk boundaries (see parallel/hostpool.py)
CHUNK_PARALLEL_SIZE = 256 * 1024
from .common import WINDOW_SIZE as _WINDOW


class Deflater:
    """Incremental raw-DEFLATE compressor with BIT-level state across
    calls — the reference's `FlushMode::None` contract (reference
    src/compress/mod.rs:424-429,604-691): `compress(data)` emits the
    complete blocks for `data` WITHOUT byte alignment; the trailing
    partial byte (`pending_bits` valid low bits) and the 32 KiB LZ
    history persist until a SYNC or FINISH flush. The concatenation of
    everything returned is one valid DEFLATE stream.

    Levels 1-12 use the native bit-phase engine; without a C toolchain
    (and for level 0, whose stored blocks are byte-aligned by format)
    NONE degrades to SYNC — byte-identical decoded output, marginally
    larger stream.
    """

    def __init__(self, level: int = 6) -> None:
        from .common import MAX_LEVEL, MIN_LEVEL
        from .utils.errors import LevelError
        if not (MIN_LEVEL <= level <= MAX_LEVEL):
            raise LevelError(f"compression level {level} outside 0..=12")
        self._level = level
        self._history = b""
        self._partial = 0          # pending byte value (low bits valid)
        self._nbits = 0            # 0..7 valid bits in _partial
        self._finished = False

    @property
    def pending_bits(self) -> int:
        """Valid bits of the retained partial byte (the reference's
        `valid_bits` return, reference src/compress/mod.rs:690)."""
        return self._nbits

    @property
    def finished(self) -> bool:
        return self._finished

    def compress(self, data, flush: Flush = Flush.NONE) -> bytes:
        if self._finished:
            raise ValueError("compress after FINISH")
        data = bytes(data)
        if flush == Flush.NONE and not data:
            return b""
        from .native.host import native_deflate_bits
        mode = {Flush.NONE: 0, Flush.SYNC: 1, Flush.FINISH: 2}[flush]
        res = None
        if 1 <= self._level <= 12:
            res = native_deflate_bits(data, self._level, mode,
                                      self._history, self._nbits)
        if res is None:
            # portable level-0 path: byte-aligned join (SYNC) — decoded
            # bytes identical, stream marginally larger. Level 0 takes
            # it from the first call on, so no bit-phase can be pending.
            assert self._nbits == 0
            out = compress_raw(data, self._level,
                               Flush.FINISH if flush == Flush.FINISH
                               else Flush.SYNC, history=self._history)
            self._history = (self._history + data)[-_WINDOW:]
            if flush == Flush.FINISH:
                self._finished = True
            return out
        arr, bits = res
        self._history = (self._history + data)[-_WINDOW:]
        nfull = bits >> 3
        arr[0] |= self._partial
        out = arr[:nfull].tobytes()
        self._nbits = bits & 7
        self._partial = int(arr[nfull]) if self._nbits else 0
        if flush == Flush.FINISH:
            # byte-aligned by bw_finish; nbits is 0 here
            self._finished = True
        return out


def _compress_one_chunk(args) -> bytes:
    data, level, flush_code, history = args
    from .native.host import native_deflate
    out = native_deflate(data, level, flush_code, history)
    if out is not None:
        return out
    flush = Flush.SYNC if flush_code == 1 else Flush.FINISH
    return deflate_host(data, level, flush, history=history)


def compress_raw(data: bytes, level: int, flush: Flush = Flush.FINISH,
                 history: bytes = b"") -> bytes:
    """Raw DEFLATE at any level, native fast path for 1-12; inputs over
    256 KiB compress as parallel SYNC-joined chunks on the host pool."""
    n = len(data)
    if 1 <= level <= 12 and n > 0:
        if n > CHUNK_PARALLEL_SIZE:
            from .parallel.hostpool import pmap, pool_width
            if pool_width() > 1:
                jobs = []
                pos = 0
                while pos < n:
                    end = min(pos + CHUNK_PARALLEL_SIZE, n)
                    hist = history if pos == 0 \
                        else data[max(0, pos - _WINDOW):pos]
                    code = _FLUSH_CODE[flush] if end == n else 1
                    jobs.append((data[pos:end], level, code, hist))
                    pos = end
                return b"".join(pmap(_compress_one_chunk, jobs))
        from .native.host import native_deflate
        out = native_deflate(data, level, _FLUSH_CODE[flush], history)
        if out is not None:
            return out
    return deflate_host(data, level, flush, history=history)


def decompress_raw(data: bytes, max_out: int):
    """One-shot raw DEFLATE decode -> (bytes, consumed)."""
    from .native.host import native_inflate
    res = native_inflate(data, max_out)
    if res is not None:
        return res
    d = Inflater()
    out = bytearray()
    status, consumed = d.step(data, out, max_out)
    if status == DecompressStatus.SHORT_INPUT:
        raise ShortInputError("compressed data truncated")
    if status == DecompressStatus.INSUFFICIENT_SPACE:
        raise InsufficientSpaceError("decompressed data exceeds buffer")
    return bytes(out), consumed


def crc32(data: bytes, crc: int = 0) -> int:
    from .native.host import native_crc32
    v = native_crc32(data, crc)
    if v is not None:
        return v
    from .models.portable.checksums import crc32_host
    return crc32_host(data, crc)


def adler32(data: bytes, adler: int = 1) -> int:
    from .native.host import native_adler32
    v = native_adler32(data, adler)
    if v is not None:
        return v
    from .models.portable.checksums import adler32_host
    return adler32_host(data, adler)
