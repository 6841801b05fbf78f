"""Device level-0 encoder: stored (uncompressed) DEFLATE blocks.

The device analog of the reference's CUDA batch kernel, which emits only
stored blocks one thread per stream (reference src/cuda/compress.cu:1-66,
src/batch_cuda.rs) — here one *grid row* per block with pure array ops:
each ≤65535-byte chunk gets its 5-byte header spliced in front, assembled
with static-shape concatenation (no bit packing needed; stored blocks are
byte-aligned by construction when the stream starts byte-aligned).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..common import MAX_STORED_BLOCK_LEN


def encode_block_stored(data: jnp.ndarray, valid_len: jnp.ndarray,
                        is_final: jnp.ndarray, block_size: int):
    """Encode one padded (block_size,) row as stored DEFLATE block(s).

    block_size must be ≤ MAX_STORED_BLOCK_LEN so each row is one stored
    block. Returns (out bytes (block_size+5,), nbytes)."""
    assert block_size <= MAX_STORED_BLOCK_LEN
    ln = valid_len.astype(jnp.int32)
    bfinal = jnp.where(is_final, jnp.uint8(1), jnp.uint8(0))
    hdr = jnp.stack([
        bfinal,  # 3-bit header 0b000000F0? header byte = BFINAL | (00 << 1)
        (ln & 0xFF).astype(jnp.uint8),
        ((ln >> 8) & 0xFF).astype(jnp.uint8),
        (~ln & 0xFF).astype(jnp.uint8),
        ((~ln >> 8) & 0xFF).astype(jnp.uint8),
    ])
    out = jnp.concatenate([hdr, data[:block_size]])
    # shift payload so it starts right after the 5 header bytes and the
    # total length is 5 + valid_len
    return out, ln + 5


@functools.lru_cache(maxsize=8)
def _jit_stored(block_size: int):
    f = functools.partial(encode_block_stored, block_size=block_size)
    return jax.jit(jax.vmap(f, in_axes=(0, 0, 0)))


STORED_BLOCK = 65535


def deflate_device_stored(data: bytes, block_size: int = STORED_BLOCK) -> bytes:
    """Whole-buffer level-0 raw DEFLATE on the device."""
    n = len(data)
    num = max(1, -(-n // block_size))
    rows = 1
    while rows < num:  # power-of-two bucket bounds compiled shape count
        rows *= 2
    arr = np.zeros((rows, block_size), np.uint8)
    valid = np.zeros(rows, np.int32)
    flat = np.frombuffer(data, np.uint8)
    for b in range(num):
        lo, hi = b * block_size, min(b * block_size + block_size, n)
        arr[b, : hi - lo] = flat[lo:hi]
        valid[b] = hi - lo
    final = np.zeros(rows, bool)
    final[num - 1:] = True
    out, nbytes = _jit_stored(block_size)(jnp.asarray(arr),
                                          jnp.asarray(valid),
                                          jnp.asarray(final))
    out = np.asarray(out)
    nbytes = np.asarray(nbytes)
    return b"".join(out[b, : int(nbytes[b])].tobytes() for b in range(num))
