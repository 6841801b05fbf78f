"""Device checksum kernels (plain JAX/XLA, matmul-formulated).

This layer replaces the reference's runtime-dispatched SIMD checksum tiers
(reference src/crc32/x86.rs PCLMULQDQ folding, src/adler32/x86.rs VNNI dot
products) with formulations built on matrix products:

 - **CRC-32 as a GF(2) matmul.** The CRC register is a linear function of
   the message bits, so the CRC of an L-byte chunk is the parity (mod-2) of
   `bits(chunk) @ K`, where K is an (8L, 32) 0/1 constant matrix built on
   the host from the shift-by-one-byte operator. 0/1 matmuls accumulate
   exactly in f32 (sums ≤ 8L << 2^24), so the matrix product does the
   heavy lifting at 256 MACs/byte. Chunk registers then fold with the associative
   shift-combine in a log-depth tree of vectorized 32-step bit-matrix
   applications.

 - **Adler-32 as chunked dot products.** Per-chunk byte sums and
   position-weighted sums via matmul against [ones, arange] weights (exact
   in f32 for 128-byte chunks), then closed-form recombination with
   hierarchical mod-65521 reductions (int32-safe throughout).

Every float32 product asks for Precision.HIGHEST: the sums are exact in
float32 but not in the TF32 a GPU may otherwise use for them.

Both kernels take uint8 arrays of static shape plus the true length as a
traced scalar is NOT supported — lengths are static per compiled shape,
which matches the batch API's padded-bucket design.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .checksum_math import (
    ADLER_MOD,
    CRC_TABLE,
    SHIFT8,
    crc32_shift_operator,
    mat_apply,
    mat_mul,
)

CRC_CHUNK = 1024          # bytes per GF(2) matmul row-chunk
ADLER_CHUNK = 128         # bytes per adler matmul chunk (exactness bound)


# ---------------------------------------------------------------------------
# Host-side constant builders (cached per chunk size)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _crc_bitmatrix(chunk_len: int) -> np.ndarray:
    """(8*chunk_len, 32) 0/1 matrix: row 8j+k = CRC contribution of bit k of
    byte j (distance chunk_len-1-j from the chunk end), zero-init register."""
    basis = np.array([CRC_TABLE[1 << k] for k in range(8)], dtype=np.uint32)
    rows = np.zeros((chunk_len, 8), dtype=np.uint32)
    cur = basis.copy()
    for j in range(chunk_len - 1, -1, -1):
        rows[j] = cur
        if j > 0:
            cur = mat_apply(SHIFT8, cur)
    flat = rows.reshape(chunk_len * 8)
    bits = ((flat[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1)
    return bits.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _shift_matrix_u32(nbytes: int) -> np.ndarray:
    """Shift-by-nbytes operator as 32 uint32 columns (host-built constant)."""
    return crc32_shift_operator(nbytes).astype(np.uint32)


_BIT_WEIGHTS_U32 = (np.uint32(1) << np.arange(32, dtype=np.uint32))


def _pack_bits_u32(par: jnp.ndarray) -> jnp.ndarray:
    """(..., 32) 0/1 -> uint32 via weighted sum.

    Deliberately NOT a chained OR-of-shifts: that pattern miscompiles on
    the XLA CPU backend shipped here (bits 16..23 corrupted under jit);
    a weighted uint32 sum of disjoint bits is equivalent.
    """
    w = jnp.asarray(_BIT_WEIGHTS_U32)
    return jnp.sum(par.astype(jnp.uint32) * w, axis=-1, dtype=jnp.uint32)


def _u32_to_bits_f(v: jnp.ndarray) -> jnp.ndarray:
    """uint32 (...,) -> (..., 32) float32 bits, LSB-first."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return ((v[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.float32)


def _jnp_mat_apply(cols: np.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Apply a constant GF(2) bit-matrix to uint32 value(s): formulated as
    a 0/1 matmul mod 2 (exact in f32)."""
    mbits = ((cols.astype(np.uint32)[:, None]
              >> np.arange(32, dtype=np.uint32)[None, :]) & 1).astype(np.float32)
    vbits = _u32_to_bits_f(v)
    acc = jnp.dot(vbits, jnp.asarray(mbits),
                  preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return _pack_bits_u32(acc.astype(jnp.int32) & 1)


# ---------------------------------------------------------------------------
# CRC-32
# ---------------------------------------------------------------------------


def _bytes_to_bits_f(x: jnp.ndarray) -> jnp.ndarray:
    """(..., L) uint8 -> (..., 8L) float32 bits, LSB-first per byte."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (x[..., None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8).astype(jnp.float32)


def crc32_fixed(data: jnp.ndarray, length: int, crc_in: jnp.ndarray | int = 0):
    """CRC-32 of data[:length] (length static). data: uint8 (N,) padded
    to a multiple of CRC_CHUNK with zeros beyond `length`.

    Returns uint32 scalar. Works under jit/vmap; the zero padding is
    corrected exactly because trailing zero bytes only shift the register,
    and we build the fold constants for the true length.
    """
    n = int(length)
    if n == 0:
        return jnp.uint32(crc_in)
    pad_n = data.shape[0]
    assert pad_n % CRC_CHUNK == 0 and pad_n >= n
    num_chunks = pad_n // CRC_CHUNK
    k = jnp.asarray(_crc_bitmatrix(CRC_CHUNK))
    bits = _bytes_to_bits_f(data.reshape(num_chunks, CRC_CHUNK))
    acc = jnp.dot(bits, k, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    regs = _pack_bits_u32(acc.astype(jnp.int32) & 1)
    # Log-depth fold: combine(left,right) = shift(left, right_len) ^ right.
    # Odd level sizes append a zero register — the register of a span of
    # zero bytes — which keeps every level uniform; the virtual length it
    # adds is undone below together with the data padding (the shift
    # operator is invertible over GF(2)).
    span = CRC_CHUNK
    virtual_len = pad_n
    while regs.shape[0] > 1:
        if regs.shape[0] % 2:
            regs = jnp.concatenate([regs, jnp.zeros(1, jnp.uint32)])
            virtual_len += span
        left, right = regs[0::2], regs[1::2]
        op = _shift_matrix_u32(span)
        regs = _jnp_mat_apply(op, left) ^ right
        span *= 2
    reg_zeroinit = regs[0]
    # register of (M || 0^p) with init: S8^{virtual_len}(init) ^ A(M || 0^p)
    init = jnp.uint32(crc_in) ^ jnp.uint32(0xFFFFFFFF)
    shifted_init = _jnp_mat_apply(_shift_matrix_u32(virtual_len),
                                  init[None])[0]
    reg = reg_zeroinit ^ shifted_init
    pad = virtual_len - n
    if pad:
        inv = _inverse_shift_u32(pad)
        reg = _jnp_mat_apply(inv, reg[None])[0]
    return reg ^ jnp.uint32(0xFFFFFFFF)


@functools.lru_cache(maxsize=64)
def _inverse_shift_u32(nbytes: int) -> np.ndarray:
    """Inverse of the shift-by-nbytes operator (GF(2) matrix inverse via
    Gauss-Jordan on 32x32 bits)."""
    m = crc32_shift_operator(nbytes)
    # build 32x32 boolean matrix: M[r, c] = bit r of column c
    a = np.zeros((32, 64), dtype=np.uint8)
    for c in range(32):
        for r in range(32):
            a[r, c] = (int(m[c]) >> r) & 1
        a[c, 32 + c] = 1
    row = 0
    for col in range(32):
        piv = None
        for r in range(row, 32):
            if a[r, col]:
                piv = r
                break
        assert piv is not None, "shift operator must be invertible"
        a[[row, piv]] = a[[piv, row]]
        for r in range(32):
            if r != row and a[r, col]:
                a[r] ^= a[row]
        row += 1
    inv_cols = np.zeros(32, dtype=np.uint32)
    for c in range(32):
        v = 0
        for r in range(32):
            if a[r, 32 + c]:
                v |= 1 << r
        inv_cols[c] = v
    return inv_cols


# ---------------------------------------------------------------------------
# Adler-32
# ---------------------------------------------------------------------------


def _mod_reduce_sum(x: jnp.ndarray, mod: int = ADLER_MOD) -> jnp.ndarray:
    """Exact int32 modular sum of a vector whose entries are < mod."""
    # group sizes keep partial sums below 2^31: 16384 * 65520 < 2^31
    v = x
    while v.shape[0] > 1:
        g = min(16384, v.shape[0])
        pad = (-v.shape[0]) % g
        if pad:
            v = jnp.concatenate([v, jnp.zeros(pad, v.dtype)])
        v = jnp.sum(v.reshape(-1, g), axis=1) % mod
    return v[0]


def _mulmod(a: jnp.ndarray, b: jnp.ndarray, mod: int = ADLER_MOD) -> jnp.ndarray:
    """(a*b) mod m for a,b < m, int32-safe: split b into 8-bit halves."""
    b_hi = b >> 8
    b_lo = b & 0xFF
    hi = (a * b_hi) % mod          # ≤ 65520*255 < 2^25
    return (((hi << 8) % mod) + (a * b_lo)) % mod


def adler32_fixed(data: jnp.ndarray, length: int,
                  adler_in: jnp.ndarray | int = 1) -> jnp.ndarray:
    """Adler-32 of data[:length] (length static, data zero-padded)."""
    n = int(length)
    a_in = jnp.uint32(adler_in)
    s1_in = (a_in & jnp.uint32(0xFFFF)).astype(jnp.int32)
    s2_in = (a_in >> jnp.uint32(16)).astype(jnp.int32)
    if n == 0:
        return a_in
    pad_n = data.shape[0]
    assert pad_n % ADLER_CHUNK == 0 and pad_n >= n
    c = pad_n // ADLER_CHUNK
    d = data.reshape(c, ADLER_CHUNK).astype(jnp.float32)
    w = np.stack([np.ones(ADLER_CHUNK, np.float32),
                  np.arange(ADLER_CHUNK, dtype=np.float32)], axis=1)
    sums = jnp.dot(d, jnp.asarray(w), preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    s1_c = sums[:, 0].astype(jnp.int32)      # Σ bytes per chunk, ≤ 32640
    j_c = sums[:, 1].astype(jnp.int32)       # Σ j*byte per chunk, ≤ 2.1e6
    # Σ_i (n-i) d_i  =  Σ_c [ (n - c*L) * S1_c - J_c ]
    coef = (np.int64(n) - np.arange(c, dtype=np.int64) * ADLER_CHUNK) % ADLER_MOD
    term = _mulmod(jnp.asarray(coef.astype(np.int32)), s1_c % ADLER_MOD)
    weighted = (_mod_reduce_sum(term) - _mod_reduce_sum(j_c % ADLER_MOD)) % ADLER_MOD
    total = _mod_reduce_sum(s1_c % ADLER_MOD)
    s1 = (s1_in + total) % ADLER_MOD
    n_s1 = _mulmod(jnp.int32(n % ADLER_MOD), s1_in % ADLER_MOD)
    s2 = (s2_in + n_s1 + weighted) % ADLER_MOD
    return (s2.astype(jnp.uint32) << jnp.uint32(16)) | s1.astype(jnp.uint32)


# ---------------------------------------------------------------------------
# Batched per-block checksums with *traced* lengths
# ---------------------------------------------------------------------------


def crc32_blocks(data: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """CRC-32 of each row's first lengths[b] bytes; rows zero-padded.

    data: (B, S) uint8 with S a static multiple of CRC_CHUNK; lengths: (B,)
    traced int32. The zero padding is undone by conditionally applying
    inverse-shift matrices for each power-of-two byte count (log2(S) masked
    GF(2) matmuls), so lengths can vary per row inside one compiled kernel.
    """
    b, s = data.shape
    assert s % CRC_CHUNK == 0
    num_chunks = s // CRC_CHUNK
    k = jnp.asarray(_crc_bitmatrix(CRC_CHUNK))
    bits = _bytes_to_bits_f(data.reshape(b, num_chunks, CRC_CHUNK))
    acc = jnp.dot(bits.reshape(b * num_chunks, -1), k,
                  preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    regs = _pack_bits_u32(acc.astype(jnp.int32) & 1).reshape(b, num_chunks)
    span = CRC_CHUNK
    virtual_len = s
    while regs.shape[1] > 1:
        if regs.shape[1] % 2:
            regs = jnp.concatenate(
                [regs, jnp.zeros((b, 1), jnp.uint32)], axis=1)
            virtual_len += span
        left, right = regs[:, 0::2], regs[:, 1::2]
        op = _shift_matrix_u32(span)
        regs = _jnp_mat_apply(op, left) ^ right
        span *= 2
    reg = regs[:, 0]
    # init = 0xFFFFFFFF shifted past the full virtual length
    init = jnp.full(b, 0xFFFFFFFF, jnp.uint32)
    reg = reg ^ _jnp_mat_apply(_shift_matrix_u32(virtual_len), init)
    # undo per-row padding: pad = virtual_len - lengths, bit-decomposed
    pad = jnp.int32(virtual_len) - lengths.astype(jnp.int32)
    nbits_needed = max(1, int(np.ceil(np.log2(virtual_len + 1))))
    for t in range(nbits_needed):
        stepped = _jnp_mat_apply(_inverse_shift_u32(1 << t), reg)
        take = ((pad >> t) & 1).astype(bool)
        reg = jnp.where(take, stepped, reg)
    return reg ^ jnp.uint32(0xFFFFFFFF)


def adler32_blocks(data: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Adler-32 of each row's first lengths[b] bytes (rows zero-padded).

    Zero bytes do not change s1, and their s2 contribution is len-weighted —
    computed in closed form, so padding is corrected exactly:
    s2_true = s2_padded_formula with n replaced by the true length; since
    padded bytes are zero, Σ(n-i)d_i over the true range equals
    Σ(n_true - i)d_i when the weight uses n_true. We therefore weight with
    per-row true lengths directly.
    """
    b, s = data.shape
    assert s % ADLER_CHUNK == 0
    c = s // ADLER_CHUNK
    d = data.reshape(b, c, ADLER_CHUNK).astype(jnp.float32)
    w = np.stack([np.ones(ADLER_CHUNK, np.float32),
                  np.arange(ADLER_CHUNK, dtype=np.float32)], axis=1)
    sums = jnp.dot(d.reshape(b * c, ADLER_CHUNK), jnp.asarray(w),
                   preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST).reshape(b, c, 2)
    s1_c = sums[:, :, 0].astype(jnp.int32) % ADLER_MOD
    j_c = sums[:, :, 1].astype(jnp.int32) % ADLER_MOD
    n = lengths.astype(jnp.int32)
    chunk_off = (jnp.arange(c, dtype=jnp.int32) * ADLER_CHUNK)[None, :]
    coef = (n[:, None] - chunk_off) % ADLER_MOD
    term = _mulmod(coef, s1_c)
    weighted = (_mod_reduce_rows(term) - _mod_reduce_rows(j_c)) % ADLER_MOD
    total = _mod_reduce_rows(s1_c)
    s1 = (1 + total) % ADLER_MOD
    s2 = ((n % ADLER_MOD) + weighted) % ADLER_MOD
    return (s2.astype(jnp.uint32) << jnp.uint32(16)) | s1.astype(jnp.uint32)


def _mod_reduce_rows(x: jnp.ndarray, mod: int = ADLER_MOD) -> jnp.ndarray:
    """Exact int32 modular sum along the last axis (entries < mod)."""
    v = x
    while v.shape[-1] > 1:
        g = min(16384, v.shape[-1])
        pad = (-v.shape[-1]) % g
        if pad:
            v = jnp.concatenate(
                [v, jnp.zeros((*v.shape[:-1], pad), v.dtype)], axis=-1)
        v = jnp.sum(v.reshape(*v.shape[:-1], -1, g), axis=-1) % mod
    return v[..., 0]


# ---------------------------------------------------------------------------
# Convenience: device checksums over byte strings
# ---------------------------------------------------------------------------


def _pad_to(arr: np.ndarray, multiple: int) -> np.ndarray:
    pad = (-len(arr)) % multiple
    if pad:
        return np.concatenate([arr, np.zeros(pad, np.uint8)])
    return arr


@functools.lru_cache(maxsize=512)
def _jit_crc(padded_len: int, length: int):
    fn = lambda d, c: crc32_fixed(d, length, c)
    return jax.jit(fn)


@functools.lru_cache(maxsize=512)
def _jit_adler(padded_len: int, length: int):
    fn = lambda d, a: adler32_fixed(d, length, a)
    return jax.jit(fn)


def crc32_device(data: bytes, crc: int = 0) -> int:
    """One-call device CRC-32 of a byte string (pads + jits per shape)."""
    arr = _pad_to(np.frombuffer(data, dtype=np.uint8), CRC_CHUNK)
    if len(arr) == 0:
        return crc
    return int(_jit_crc(len(arr), len(data))(jnp.asarray(arr), jnp.uint32(crc)))


def adler32_device(data: bytes, adler: int = 1) -> int:
    """One-call device Adler-32 of a byte string."""
    arr = _pad_to(np.frombuffer(data, dtype=np.uint8), ADLER_CHUNK)
    if len(arr) == 0:
        return adler
    return int(_jit_adler(len(arr), len(data))(jnp.asarray(arr),
                                               jnp.uint32(adler)))
