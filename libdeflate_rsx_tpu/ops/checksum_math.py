"""Checksum algebra shared by host and device paths (pure numpy, no JAX).

CRC-32 (reflected poly 0xEDB88320, gzip) is GF(2)-linear: the register
update is a linear map, so per-shard CRCs combine with a "shift by N bytes"
operator computed by square-and-multiply over 32x32 bit-matrices. Adler-32
parts combine with modular arithmetic. These associative combines are what
let the device path reduce per-block checksums with a small psum-style tree
instead of a serial pass (SURVEY.md §2 "Distributed communication backend").

The reference implements these checksums as runtime-dispatched SIMD kernels
(reference src/crc32/, src/adler32/); the device equivalents live in
ops/checksums.py and are validated against this module and CPython zlib.
"""

from __future__ import annotations

import numpy as np

CRC32_POLY = np.uint32(0xEDB88320)
ADLER_MOD = 65521


def _build_crc_table() -> np.ndarray:
    """256-entry byte-at-a-time table for the reflected polynomial."""
    t = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        r = np.uint32(b)
        for _ in range(8):
            r = (r >> np.uint32(1)) ^ (CRC32_POLY if (r & np.uint32(1)) else np.uint32(0))
        t[b] = r
    return t


CRC_TABLE = _build_crc_table()


# -- GF(2) 32x32 bit-matrix ops (matrix = 32 uint32 columns) ----------------


def mat_apply(m: np.ndarray, v):
    """Apply bit-matrix m to uint32 value(s) v (vectorized over arrays)."""
    v = np.asarray(v, dtype=np.uint32)
    r = np.zeros_like(v)
    for i in range(32):
        bit = (v >> np.uint32(i)) & np.uint32(1)
        r ^= np.where(bit.astype(bool), m[i], np.uint32(0))
    return r if r.shape else np.uint32(r)


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose bit-matrices: (a @ b)(v) == a(b(v))."""
    return np.array([mat_apply(a, b[i]) for i in range(32)], dtype=np.uint32)


def _shift8_matrix() -> np.ndarray:
    """Register update for one zero byte: r -> table[r & 0xFF] ^ (r >> 8)."""
    cols = np.zeros(32, dtype=np.uint32)
    for i in range(32):
        r = np.uint32(1) << np.uint32(i)
        cols[i] = CRC_TABLE[int(r & np.uint32(0xFF))] ^ (r >> np.uint32(8))
    return cols


SHIFT8 = _shift8_matrix()

_shift_cache: dict[int, np.ndarray] = {}


def crc32_shift_operator(nbytes: int) -> np.ndarray:
    """Bit-matrix advancing the CRC register past nbytes zero bytes."""
    if nbytes in _shift_cache:
        return _shift_cache[nbytes]
    result = np.array([np.uint32(1) << np.uint32(i) for i in range(32)],
                      dtype=np.uint32)  # identity
    base = SHIFT8
    n = nbytes
    while n:
        if n & 1:
            result = mat_mul(base, result)
        base = mat_mul(base, base)
        n >>= 1
    if len(_shift_cache) < 256:
        _shift_cache[nbytes] = result
    return result


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concatenated messages from their individual CRCs."""
    if len2 == 0:
        return crc1 & 0xFFFFFFFF
    op = crc32_shift_operator(len2)
    return int(mat_apply(op, np.uint32(crc1)) ^ np.uint32(crc2)) & 0xFFFFFFFF


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """Adler-32 of concatenated messages from their individual checksums."""
    rem = len2 % ADLER_MOD
    s1_1 = adler1 & 0xFFFF
    s2_1 = (adler1 >> 16) & 0xFFFF
    s1_2 = adler2 & 0xFFFF
    s2_2 = (adler2 >> 16) & 0xFFFF
    s1 = (s1_1 + s1_2 - 1) % ADLER_MOD
    s2 = (s2_1 + s2_2 + rem * (s1_1 - 1)) % ADLER_MOD
    return ((s2 << 16) | s1) & 0xFFFFFFFF
