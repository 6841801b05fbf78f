"""Device dynamic-Huffman encoder tier: greedy parse + per-block code tables.

The ratio tier of the device encoder family (the reference's dynamic
blocks, reference src/compress/mod.rs:1775-1883): the same sort-based
match pipeline as the static tier, plus per-block symbol histograms on
device, package-merge code construction + header serialization on the
host (native dyn_tables_c; a few KB of histogram per block crosses the
link), and table-coded emission through the shared matmul bit packer.

Blocks where the dynamic stream would expand past the stored cost fall
back to stored blocks host-side, like the static tier.
"""

from __future__ import annotations

import numpy as np

from ..ops.encode_dynamic import (
    build_tables_host,
    jit_analyze,
    jit_emit,
)
from .greedy_static import MAX_STORED, _stored_block, split_blocks

DEFAULT_BLOCK = 65536


def _or_bits(buf: np.ndarray, bitpos: int, value: int, nbits: int) -> None:
    """OR `nbits` of `value` into buf starting at absolute bit `bitpos`."""
    if nbits <= 0:
        return
    v = value << (bitpos & 7)
    b = bitpos >> 3
    nby = ((bitpos & 7) + nbits + 7) // 8
    for k in range(nby):
        buf[b + k] |= (v >> (8 * k)) & 0xFF


def assemble_dynamic(device_out, headers, hdr_bits: np.ndarray,
                     ll_tabs: np.ndarray, finals: np.ndarray,
                     num: int, out_cap: int) -> list[bytes]:
    """Host assembly: header bytes + OR-placed device rows + EOB +
    final/SYNC trailer per block."""
    rows, byte_off, row_bit0, end_bits = (np.asarray(a) for a in device_out)
    byte_off = byte_off.astype(np.int64)
    row_bit0 = row_bit0.astype(np.int64)
    end_bits = end_bits.astype(np.int64)
    out = np.zeros((num, out_cap), dtype=np.uint8)
    for i in range(num):
        h = np.frombuffer(headers[i], np.uint8)
        out[i, : len(h)] = h

    nxt = np.concatenate([row_bit0[:, 1:], end_bits[:, None]], axis=1)
    bits_r = nxt - row_bit0
    extent = ((row_bit0 & 7) + bits_r + 7) // 8
    extent = np.minimum(extent, rows.shape[2])

    from ..native import assemble_rows_native
    if not assemble_rows_native(out, rows, byte_off, extent):
        b, r, w = rows.shape
        kk = np.arange(w)[None, None, :]
        gidx = np.minimum(byte_off[:, :, None] + kk, out_cap - 1)
        use = kk < extent[:, :, None]
        bidx = np.broadcast_to(np.arange(b)[:, None, None], gidx.shape)
        np.bitwise_or.at(out, (bidx[use], gidx[use]), rows[use])

    parts: list[bytes] = []
    for i in range(num):
        ent = int(ll_tabs[i, 256])
        eob_code, eob_len = ent & 0xFFFF, ent >> 16
        end = int(end_bits[i])
        _or_bits(out[i], end, eob_code, eob_len)
        total = end + eob_len
        if finals[i]:
            nb = (total + 7) // 8
        else:
            # SYNC join: 3-bit empty-stored header (000) + byte align +
            # LEN/NLEN 00 00 FF FF (reference src/compress/mod.rs:662-681)
            nb = (total + 3 + 7) // 8 + 4
            out[i, nb - 4: nb] = (0, 0, 0xFF, 0xFF)
        parts.append(out[i, :nb].tobytes())
    return parts


def apply_stored_fallback(parts: list[bytes], data: bytes,
                          block_size: int, valid: np.ndarray,
                          finals: np.ndarray, num: int) -> list[bytes]:
    """Per-block stored fallback when the dynamic stream expands
    (reference src/compress/mod.rs:1400-1464's whenever-cheaper rule)."""
    for i in range(num):
        v = int(valid[i])
        stored_cost = v + 5 * max(1, -(-v // MAX_STORED))
        if len(parts[i]) > stored_cost:
            raw = data[i * block_size: i * block_size + v]
            parts[i] = _stored_block(raw, bool(finals[i]))
    return parts


def deflate_device_dynamic(data: bytes,
                           block_size: int = DEFAULT_BLOCK) -> bytes:
    """Whole-buffer raw-DEFLATE encode, dynamic-Huffman device tier."""
    import jax.numpy as jnp

    arr, valid, finals, num = split_blocks(data, block_size)
    arr_j = jnp.asarray(arr)
    ml, dist, sel, lit, llh, ofh = jit_analyze(block_size)(
        arr_j, jnp.asarray(valid))
    ll_tabs, of_tabs, headers, hdr_bits = build_tables_host(
        llh, ofh, finals)
    device_out = jit_emit(block_size)(
        arr_j, ml, dist, sel, lit, jnp.asarray(ll_tabs),
        jnp.asarray(of_tabs), jnp.asarray(hdr_bits.astype(np.int32)))
    out_cap = 2 * block_size + 1024
    parts = assemble_dynamic(device_out, headers, hdr_bits, ll_tabs,
                             finals, num, out_cap)
    return b"".join(apply_stored_fallback(parts, data, block_size, valid,
                                          finals, num))


def split_blocks_hist(data: bytes, block_size: int):
    """Blocks with a 32 KiB history prefix from the preceding payload
    (the reference keeps the matchfinder window across block boundaries;
    chunked device encode without carry measured -5.5% ratio on the
    silesia corpus — scripts/eval_matchfinder.py)."""
    from ..ops.encode_dynamic import HIST
    from ..ops.encode_v2 import BLOCK_PAD
    n = len(data)
    num = max(1, -(-n // block_size))
    s = HIST + block_size
    arr = np.zeros((num, s + BLOCK_PAD), np.uint8)
    valid = np.zeros(num, np.int32)
    hist_start = np.zeros(num, np.int32)
    flat = np.frombuffer(data, np.uint8)
    for i in range(num):
        lo = i * block_size
        hi = min(lo + block_size, n)
        h = min(HIST, lo)
        arr[i, HIST - h: HIST + hi - lo] = flat[lo - h:hi]
        valid[i] = HIST + hi - lo
        hist_start[i] = HIST - h
    finals = np.zeros(num, bool)
    finals[-1] = True
    return arr, valid, hist_start, finals, num


def _encode_l6_blocks(arr, valid, hist_start, finals, block_size):
    """Shared L6-tier device flow: analyze -> host tables -> emit."""
    import jax.numpy as jnp

    from ..ops.encode_dynamic import HIST, jit_analyze_l6
    arr_j = jnp.asarray(arr)
    ml, dist, sel, lit, llh, ofh = jit_analyze_l6(block_size)(
        arr_j, jnp.asarray(valid), jnp.asarray(hist_start))
    ll_tabs, of_tabs, headers, hdr_bits = build_tables_host(
        llh, ofh, finals)
    device_out = jit_emit(block_size)(
        arr_j[:, HIST:], ml, dist, sel, lit, jnp.asarray(ll_tabs),
        jnp.asarray(of_tabs), jnp.asarray(hdr_bits.astype(np.int32)))
    out_cap = 2 * block_size + 1024
    return assemble_dynamic(device_out, headers, hdr_bits, ll_tabs,
                            finals, arr.shape[0], out_cap)


def deflate_device_l6(data: bytes,
                      block_size: int = DEFAULT_BLOCK) -> bytes:
    """Whole-buffer raw-DEFLATE encode, L6 ratio tier: strided prefix
    ladder matchfinding + 32 KiB cross-block history + lazy demotion +
    per-block optimal dynamic tables (see ops/encode_dynamic.HIST et
    seq.). Targets libdeflate-6-class ratio on device."""
    from ..ops.encode_dynamic import HIST
    arr, valid, hist_start, finals, num = split_blocks_hist(
        data, block_size)
    parts = _encode_l6_blocks(arr, valid, hist_start, finals, block_size)
    return b"".join(apply_stored_fallback(
        parts, data, block_size, valid - HIST, finals, num))


def deflate_device_l6_many(datas: list[bytes],
                           block_size: int = DEFAULT_BLOCK
                           ) -> list[bytes]:
    """Batched L6-ratio-tier encode of many independent buffers: all
    items' history-prefixed blocks ride one analyze launch, one
    histogram fetch, and one emit launch (same pipelining shape as
    deflate_device_dynamic_many; history never crosses item bounds)."""
    from ..ops.encode_dynamic import HIST
    metas = []
    arrs, valids, hists, finals_l = [], [], [], []
    row = 0
    for data in datas:
        arr, valid, hist_start, finals, num = split_blocks_hist(
            data, block_size)
        metas.append((row, num, data, finals))
        row += num
        arrs.append(arr)
        valids.append(valid)
        hists.append(hist_start)
        finals_l.append(finals)
    if not metas:
        return []
    arr = np.concatenate(arrs)
    valid = np.concatenate(valids)
    hist_start = np.concatenate(hists)
    finals = np.concatenate(finals_l)
    parts = _encode_l6_blocks(arr, valid, hist_start, finals, block_size)
    outs = []
    for start, num, data, fin in metas:
        item_parts = apply_stored_fallback(
            parts[start:start + num], data, block_size,
            valid[start:start + num] - HIST, fin, num)
        outs.append(b"".join(item_parts))
    return outs


def deflate_device_dynamic_many(datas: list[bytes],
                                block_size: int = DEFAULT_BLOCK
                                ) -> list[bytes]:
    """Batched dynamic-tier encode of many independent buffers.

    All items' blocks ride ONE analyze launch, ONE histogram fetch, and
    ONE emit launch: one batched histogram fetch instead of a host
    round trip per item. Per-item
    outputs are reassembled in order.
    """
    import jax.numpy as jnp

    metas = []
    blocks_l, valids_l, finals_l = [], [], []
    row = 0
    for data in datas:
        arr, valid, finals, num = split_blocks(data, block_size)
        metas.append((row, num, data, finals))
        row += num
        blocks_l.append(arr)
        valids_l.append(valid)
        finals_l.append(finals)
    if not metas:
        return []
    blocks = np.concatenate(blocks_l)
    valids = np.concatenate(valids_l)
    finals = np.concatenate(finals_l)

    arr_j = jnp.asarray(blocks)
    ml, dist, sel, lit, llh, ofh = jit_analyze(block_size)(
        arr_j, jnp.asarray(valids))
    ll_tabs, of_tabs, headers, hdr_bits = build_tables_host(
        llh, ofh, finals)
    device_out = jit_emit(block_size)(
        arr_j, ml, dist, sel, lit, jnp.asarray(ll_tabs),
        jnp.asarray(of_tabs), jnp.asarray(hdr_bits.astype(np.int32)))
    out_cap = 2 * block_size + 1024
    parts = assemble_dynamic(device_out, headers, hdr_bits, ll_tabs,
                             finals, row, out_cap)
    outs = []
    for start, num, data, fin in metas:
        item_parts = apply_stored_fallback(
            parts[start:start + num], data, block_size,
            valids[start:start + num], fin, num)
        outs.append(b"".join(item_parts))
    return outs
