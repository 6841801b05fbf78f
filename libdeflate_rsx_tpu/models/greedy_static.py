"""Device level-1 encoder: greedy parse + static Huffman, gather/scatter-free.

Flagship device model (v3 pipeline, ops/encode_v2.py): sort-based
matchfinding, run-merge extension, scan+lean-walk greedy token selection,
closed-form static codes, matmul one-hot word packing. Blocks are independent
(the reference's intra-buffer chunk parallelism, reference
src/compress/mod.rs:699-772) and joined byte-aligned via SYNC markers, so
block streams concatenate into one valid DEFLATE stream; batches of blocks
run under jax.vmap / shard_map.

Blocks whose static-code stream would expand beyond the stored-block cost
fall back to stored blocks host-side (the reference emits stored blocks
whenever cheaper, reference src/compress/mod.rs:1400-1464).

Wire-format parity: standard RFC 1951 DEFLATE — decodable by any inflate,
tested against CPython zlib.
"""

from __future__ import annotations

import numpy as np

from ..ops.encode_v2 import (
    BLOCK_PAD,
    ROW,
    assemble_blocks,
    encode_rows_static,
    jit_encoder,
)

DEFAULT_BLOCK = 65536
_OUT_FACTOR = 1.25
MAX_STORED = 65535


def _stored_block(raw: bytes, final: bool) -> bytes:
    """Byte-aligned stored block(s) for one chunk (RFC 1951 §3.2.4)."""
    out = bytearray()
    n = len(raw)
    pos = 0
    while True:
        chunk = min(n - pos, MAX_STORED)
        last = pos + chunk == n
        out.append(1 if (final and last) else 0)   # BFINAL, BTYPE=00
        out += chunk.to_bytes(2, "little")
        out += ((~chunk) & 0xFFFF).to_bytes(2, "little")
        out += raw[pos:pos + chunk]
        pos += chunk
        if last:
            return bytes(out)


def split_blocks(data: bytes, block_size: int):
    """(padded_blocks, valid_lens, finals, num) for one buffer."""
    n = len(data)
    num = max(1, -(-n // block_size))
    arr = np.zeros((num, block_size + BLOCK_PAD), dtype=np.uint8)
    valid = np.zeros(num, np.int32)
    flat = np.frombuffer(data, np.uint8)
    for i in range(num):
        lo = i * block_size
        hi = min(lo + block_size, n)
        arr[i, : hi - lo] = flat[lo:hi]
        valid[i] = hi - lo
    finals = np.zeros(num, bool)
    finals[-1] = True
    return arr, valid, finals, num


def assemble_with_fallback(data: bytes, block_size: int, device_out,
                           valid: np.ndarray, finals: np.ndarray,
                           num: int) -> list[bytes]:
    """Host assembly + per-block stored fallback when static expands."""
    rows, byte_off, rowbits, total_bits, nbytes = (
        np.asarray(a) for a in device_out)
    out_cap = int(block_size * _OUT_FACTOR) + 64
    parts = assemble_blocks(rows, byte_off.astype(np.int64),
                            rowbits.astype(np.int64), total_bits,
                            nbytes, finals, num, out_cap)
    for i in range(num):
        v = int(valid[i])
        stored_cost = v + 5 * max(1, -(-v // MAX_STORED))
        if len(parts[i]) > stored_cost:
            raw = data[i * block_size: i * block_size + v]
            parts[i] = _stored_block(raw, bool(finals[i]))
    return parts


def deflate_device_static(data: bytes,
                          block_size: int = DEFAULT_BLOCK,
                          launch_rows: int | None = None) -> bytes:
    """Whole-buffer raw-DEFLATE encode on the device (level-1 tier).

    launch_rows pins the device launch shape: large buffers are processed
    in fixed-size sub-batches of that many blocks (one compiled program,
    launches pipelined, single host sync at the end) — the analog of the
    reference's persistent per-thread compressors over 256 KB chunks
    (reference src/compress/mod.rs:699-772).
    """
    import numpy as np_
    import jax.numpy as jnp

    arr, valid, finals, num = split_blocks(data, block_size)
    if launch_rows is None or num <= launch_rows:
        enc = jit_encoder(block_size)
        out = enc(jnp.asarray(arr), jnp.asarray(valid), jnp.asarray(finals))
        return b"".join(
            assemble_with_fallback(data, block_size, out, valid, finals,
                                   num))
    # unrolled-chunk launches: UNROLL independent chunk subgraphs per jit
    # call (XLA overlaps them on-device); padding rows are empty final
    # blocks whose outputs are dropped at assembly
    from ..ops.encode_v2 import jit_encoder_scan

    # unroll=4: enough independent subgraphs to hide each chunk's
    # sort/scan dependency chain without starving the scheduler (not
    # yet re-tuned on the GPU)
    unroll = 4
    per_launch = unroll * launch_rows
    k = -(-num // per_launch)
    rows = k * per_launch
    if rows > num:
        pad = rows - num
        arr = np_.concatenate(
            [arr, np_.zeros((pad, arr.shape[1]), np_.uint8)])
        valid = np_.concatenate([valid, np_.zeros(pad, np_.int32)])
        finals = np_.concatenate([finals, np_.ones(pad, bool)])
    enc = jit_encoder_scan(block_size, unroll)
    outs = []
    for li in range(k):
        lo = li * per_launch
        a = jnp.asarray(arr[lo:lo + per_launch]).reshape(
            unroll, launch_rows, -1)
        v = jnp.asarray(valid[lo:lo + per_launch]).reshape(
            unroll, launch_rows)
        f = jnp.asarray(finals[lo:lo + per_launch]).reshape(
            unroll, launch_rows)
        outs.append(enc(a, v, f))   # async dispatch; sync at np.asarray
    flats = []
    for j in range(5):
        parts_j = [np_.asarray(o[j]) for o in outs]
        cat = np_.concatenate(parts_j)
        flats.append(cat.reshape(rows, *cat.shape[2:]))
    return b"".join(
        assemble_with_fallback(data, block_size, tuple(flats), valid,
                               finals, num))
