"""Host-side LSB-first bit I/O.

DEFLATE packs bits LSB-first within bytes; Huffman codewords are emitted
bit-reversed. These host classes are the portable analog of the reference's
64-bit Bitstream writer (reference src/compress/bitstream.rs:3-223) and the
decoder's bitbuf refill; the device path packs bits with a scan+scatter kernel
instead (ops/encode_v2.py).
"""

from __future__ import annotations


class BitWriter:
    """LSB-first bit accumulator onto a bytearray."""

    __slots__ = ("out", "bitbuf", "bitcount")

    def __init__(self) -> None:
        self.out = bytearray()
        self.bitbuf = 0
        self.bitcount = 0

    def write_bits(self, value: int, nbits: int) -> None:
        assert 0 <= nbits <= 57
        self.bitbuf |= (value & ((1 << nbits) - 1)) << self.bitcount
        self.bitcount += nbits
        while self.bitcount >= 8:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcount -= 8

    def align_byte(self) -> None:
        """Pad with zero bits to the next byte boundary."""
        if self.bitcount:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf = 0
            self.bitcount = 0

    def write_bytes(self, data: bytes) -> None:
        assert self.bitcount == 0, "write_bytes requires byte alignment"
        self.out.extend(data)

    def finish(self) -> bytes:
        """Flush any trailing partial byte (zero-padded) and return bytes."""
        self.align_byte()
        return bytes(self.out)

    def bit_length(self) -> int:
        return len(self.out) * 8 + self.bitcount


class BitReader:
    """LSB-first bit reader over a bytes-like object.

    Exposes an explicit (bitbuf, bitsleft, position) state so the resumable
    streaming decoder can suspend/restore across calls (the analog of the
    reference decompressor persisting bitbuf/bitsleft across ShortInput,
    reference src/decompress/mod.rs:37-47).
    """

    __slots__ = ("data", "pos", "bitbuf", "bitsleft")

    def __init__(self, data: bytes, pos: int = 0, bitbuf: int = 0, bitsleft: int = 0):
        self.data = data
        self.pos = pos
        self.bitbuf = bitbuf
        self.bitsleft = bitsleft

    def _refill(self, need: int) -> bool:
        while self.bitsleft < need:
            if self.pos >= len(self.data):
                return False
            self.bitbuf |= self.data[self.pos] << self.bitsleft
            self.pos += 1
            self.bitsleft += 8
        return True

    def read_bits(self, nbits: int) -> int:
        """Read nbits (consuming). Raises IndexError on exhausted input."""
        if not self._refill(nbits):
            raise IndexError("short input")
        v = self.bitbuf & ((1 << nbits) - 1)
        self.bitbuf >>= nbits
        self.bitsleft -= nbits
        return v

    def try_read_bits(self, nbits: int):
        """Read nbits, or None if input exhausted (state unchanged on None)."""
        if not self._refill(nbits):
            return None
        v = self.bitbuf & ((1 << nbits) - 1)
        self.bitbuf >>= nbits
        self.bitsleft -= nbits
        return v

    def peek_bits(self, nbits: int) -> int:
        """Peek up to nbits without consuming; short input yields zero-padded."""
        self._refill(nbits)
        return self.bitbuf & ((1 << nbits) - 1)

    def consume(self, nbits: int) -> None:
        assert nbits <= self.bitsleft
        self.bitbuf >>= nbits
        self.bitsleft -= nbits

    def align_byte(self) -> None:
        drop = self.bitsleft & 7
        self.bitbuf >>= drop
        self.bitsleft -= drop

    def read_bytes(self, n: int) -> bytes:
        """Read n whole bytes (must be byte-aligned). Raises on short input."""
        assert (self.bitsleft & 7) == 0
        out = bytearray()
        while self.bitsleft >= 8 and n > 0:
            out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitsleft -= 8
            n -= 1
        if self.pos + n > len(self.data):
            raise IndexError("short input")
        out.extend(self.data[self.pos:self.pos + n])
        self.pos += n
        return bytes(out)

    def bits_available(self) -> int:
        return self.bitsleft + 8 * (len(self.data) - self.pos)


def reverse_bits(code: int, nbits: int) -> int:
    """Bit-reverse an nbits-wide codeword (Huffman codes are stored MSB-first
    conceptually but written LSB-first on the wire)."""
    r = 0
    for _ in range(nbits):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r
