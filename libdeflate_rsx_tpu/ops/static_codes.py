"""Closed-form static-Huffman DEFLATE code computation (pure elementwise).

Table gathers were the slow operation on the accelerator this was
first written for, while elementwise ops were cheap, so the static code
tables of the reference (reference src/compress/mod.rs StaticTables, built once and then
gathered per symbol) are replaced by closed-form bit arithmetic evaluated
per position: RFC 1951 §3.2.6 static codes, the length→symbol and
offset→symbol maps, and LSB-first bit reversal — all shifts/masks/selects,
no table lookups anywhere in the hot path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U = jnp.uint32


def bitrev16(v: jnp.ndarray) -> jnp.ndarray:
    """Reverse the low 16 bits of each uint32 lane."""
    v = v.astype(U)
    v = ((v & U(0x5555)) << U(1)) | ((v & U(0xAAAA)) >> U(1))
    v = ((v & U(0x3333)) << U(2)) | ((v & U(0xCCCC)) >> U(2))
    v = ((v & U(0x0F0F)) << U(4)) | ((v & U(0xF0F0)) >> U(4))
    v = ((v & U(0x00FF)) << U(8)) | ((v & U(0xFF00)) >> U(8))
    return v


def bitrev(v: jnp.ndarray, nbits: jnp.ndarray) -> jnp.ndarray:
    """Reverse the low `nbits` (≤16) of v: DEFLATE codes are emitted
    MSB-first into an LSB-first stream, i.e. bit-reversed."""
    return bitrev16(v) >> (U(16) - nbits.astype(U))


def bsr(x: jnp.ndarray) -> jnp.ndarray:
    """Index of the highest set bit via the f32 exponent (exact for
    1 <= x < 2^24)."""
    f = jnp.maximum(x, 1).astype(jnp.float32)
    e = jax.lax.bitcast_convert_type(f, jnp.int32) >> 23
    return (e & 0xFF) - 127


def literal_code(byte: jnp.ndarray):
    """(code, nbits) of a literal byte under the static litlen code.

    RFC 1951: 0-143 -> 8 bits from 0x30, 144-255 -> 9 bits from 0x190.
    """
    b = byte.astype(jnp.int32)
    hi = b >= 144
    nbits = jnp.where(hi, 9, 8).astype(U)
    v = jnp.where(hi, 0x190 + (b - 144), 0x30 + b).astype(U)
    return bitrev(v, nbits), nbits


def length_sym_fields(length: jnp.ndarray):
    """(symbol 257..285, extra_val, extra_nbits) for match length 3..258:
    the code-independent part of the length token. Closed form of the
    reference's LENGTH_TO_SYMBOL / LENGTH_SYM_{BASE,EXTRA} tables."""
    l = length.astype(jnp.int32)
    n = l - 3
    eb_big = bsr(n) - 2                       # n >= 8
    eb = jnp.where(n < 8, 0, jnp.maximum(eb_big, 0))
    idx_small = n
    idx_big = (eb << 2) + (n >> jnp.maximum(eb, 0)).astype(jnp.int32)
    idx = jnp.where(n < 8, idx_small, idx_big)
    extra = (n & ((1 << eb) - 1)).astype(U)
    # length 258 is its own symbol 285 with no extra bits
    is258 = l == 258
    idx = jnp.where(is258, 28, idx)
    eb = jnp.where(is258, 0, eb)
    extra = jnp.where(is258, U(0), extra)
    return 257 + idx, extra, eb.astype(U)     # 257..285


def length_fields(length: jnp.ndarray):
    """(sym_code, sym_nbits, extra_val, extra_nbits) for match length
    3..258 under the static code."""
    sym, extra, eb = length_sym_fields(length)
    # static litlen: syms 256..279 are 7 bits code (sym-256);
    # 280..287 are 8 bits code (0xC0 + sym - 280)
    sym8 = sym >= 280
    nbits = jnp.where(sym8, 8, 7).astype(U)
    v = jnp.where(sym8, 0xC0 + (sym - 280), sym - 256).astype(U)
    return bitrev(v, nbits), nbits, extra, eb


def offset_sym_fields(dist: jnp.ndarray):
    """(symbol 0..29, extra_val, extra_nbits) for offset 1..32768: the
    code-independent part of the offset token. Closed form of the
    reference's OFFSET_TO_SYMBOL / OFFSET_SYM_{BASE,EXTRA} tables."""
    o = dist.astype(jnp.int32) - 1
    b = bsr(o)
    hi = 2 * b + ((o >> jnp.maximum(b - 1, 0)) & 1)
    sym = jnp.where(o < 4, o, hi).astype(jnp.int32)
    eb = jnp.maximum(sym // 2 - 1, 0)
    base = jnp.where(sym < 4, sym,
                     ((2 + (sym & 1)) << eb) - 2 + 2)  # base offset - 1
    extra = (o - base).astype(U)
    return sym, extra, eb.astype(U)


def offset_fields(dist: jnp.ndarray):
    """(sym_code5, extra_val, extra_nbits) for offset 1..32768 under the
    static code (5-bit bit-reversed symbol)."""
    sym, extra, eb = offset_sym_fields(dist)
    code = bitrev(sym.astype(U), U(5) * jnp.ones_like(sym, U))
    return code, extra, eb


def match_token(length: jnp.ndarray, dist: jnp.ndarray):
    """Fused (value, nbits) of a <length, dist> match token under the
    static code: lencode | lenextra | offcode | offextra, ≤ 31 bits."""
    lc, ln, lev, leb = length_fields(length)
    oc, oev, oeb = offset_fields(dist)
    v = lc
    nb = ln
    v = v | (lev << nb)
    nb = nb + leb
    v = v | (oc << nb)
    nb = nb + U(5)
    v = v | (oev << nb)
    nb = nb + oeb
    return v, nb
