"""Gather-free static-Huffman DEFLATE block encoder (device hot path).

Design premise (inherited from the accelerator this encoder was first
written for, where gathers and scatters were an order of magnitude
slower than sorts, scans and elementwise ops; not yet re-measured on the
GPU): this pipeline uses ONLY sorts, associative scans, elementwise ops,
and one small sequential walk — no gathers, no scatters:

 1. match finding: one stable multi-operand `lax.sort` keyed on the actual
    4-byte word at each position, carrying (pos, next 12 bytes). The
    predecessor in sorted order is the nearest previous occurrence; the
    carried words give exact verified match lengths up to 16 via
    roll-compare — replacing the reference's hash chains + SIMD
    match-length kernels (reference src/compress/matchfinder.rs).
 2. run-merge extension: consecutive positions matching at the same
    distance imply longer matches (ml[i] >= 1 + ml[i+1]); a reverse
    associative scan over (c, s, k) function compositions extends matches
    to 258 exactly for periodic/repetitive data.
 3. exact greedy cover per 128-byte row: matches are truncated at row
    boundaries, then a 128-step `fori_loop` walks every row of every block
    in parallel (lane-select via iota-compare, no gather), emitting each
    selected token's bits into a row-local byte buffer — the cover, the
    sequence emission, and the bit packing fused into one loop
    (the reference's decide_greedy_sequences + write_sequences hot loops,
    reference src/compress/mod.rs:1261-1373,1952-2155).
 4. codes come from closed-form bit arithmetic (ops/static_codes.py),
    not tables.
 5. rows are bit-shifted into global alignment on device; the final
    ragged byte placement (~0.5 KB per row) happens host-side with two
    vectorized numpy writes (assemble_blocks).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..common import MAX_MATCH_LEN, WINDOW_SIZE
from .static_codes import literal_code, match_token

U = jnp.uint32
ROW = 32                  # cover/pack row width (bytes)
ROW_OUT = 48              # row-local output buffer (bytes); max 9*32/8+pad
MAX_VEC_ML = 8            # exact verified match length from carried words
MIN_MATCH = 4
BLOCK_PAD = MAX_MATCH_LEN + 8
# plain ints (not jnp scalars): creating a device array at import time
# would initialise the XLA backend, breaking jax.distributed.initialize
# for multi-host users who import this package first
_NEG = -(1 << 20)


def _words(data_padded: jnp.ndarray, s: int):
    """Little-endian 4-byte words at offsets 0 and 4 from each position."""
    d = data_padded.astype(U)
    full = (d[:-3] | (d[1:-2] << U(8)) | (d[2:-1] << U(16))
            | (d[3:] << U(24)))
    return full[:s], full[4:s + 4]


def _prefix_bytes(x: jnp.ndarray) -> jnp.ndarray:
    """Number of matching low bytes (0-3) given the XOR of two words."""
    b0 = (x & U(0xFF)) == 0
    b1 = (x & U(0xFFFF)) == 0
    b2 = (x & U(0xFFFFFF)) == 0
    return b0.astype(jnp.int32) + b1.astype(jnp.int32) + b2.astype(jnp.int32)


def find_matches_v2(data_padded: jnp.ndarray, valid_len: jnp.ndarray,
                    block_size: int):
    """(ml, dist) per position: nearest-previous-occurrence matches with
    exact lengths up to MAX_VEC_ML, via one stable sort + roll-compares.

    The sort carries only (key, pos, next-word): 12 B/element — sort
    passes dominate the encode pipeline, so payload width is throughput
    (the reference's equivalent cost knob is hash-chain depth). Lengths
    beyond 8 come from extend_runs' same-distance composition."""
    s = block_size
    w0, w1 = _words(data_padded, s)
    pos = jnp.arange(s, dtype=jnp.int32)
    w0s, poss, w1s = jax.lax.sort(
        (w0, pos, w1), dimension=0, num_keys=1, is_stable=True)

    def prev(a):
        return jnp.concatenate([a[:1] * 0, a[:-1]])

    same = jnp.concatenate([jnp.zeros(1, bool), w0s[1:] == w0s[:-1]])
    cand = prev(poss)
    dist = poss - cand
    ok = same & (dist >= 1) & (dist <= WINDOW_SIZE)

    x1 = w1s ^ prev(w1s)
    e1 = jnp.where(x1 == 0, 4, _prefix_bytes(x1))
    ml = 4 + e1
    ml = jnp.where(ok, ml, 0)
    dist = jnp.where(ok, dist, 0)  # garbage dist would corrupt the packing

    # int32 like its permutation key: XLA's GPU permutation-sort
    # simplifier turns this sort into a scatter whose combiner takes the
    # key's type, which fails to verify for a uint32 payload
    packed = dist | (ml << 20)
    _, packed_u = jax.lax.sort((poss, packed), dimension=0, num_keys=1)
    ml_u = packed_u >> 20
    dist_u = packed_u & 0xFFFFF
    cap = jnp.clip(valid_len - pos, 0, MAX_VEC_ML)
    ml_u = jnp.minimum(ml_u, cap)
    ml_u = jnp.where(ml_u >= MIN_MATCH, ml_u, 0)
    return ml_u, dist_u


def extend_runs(ml: jnp.ndarray, dist: jnp.ndarray, valid_len: jnp.ndarray):
    """Extend capped matches through same-distance runs to MAX_MATCH_LEN.

    If positions i..t all match at distance d contiguously, the match at
    i reaches (t - i) + ml[t]. So ext[i] = max over the same-distance
    chain from i of (ml[t] + t) minus i — a SEGMENTED reverse max-scan
    of z[t] = ml[t] + t with continuation flags, an idempotent tuple op
    that runs as a two-level scan (half the passes of the previous
    3-carry function-composition scan)."""
    s = ml.shape[0]
    pos = jnp.arange(s, dtype=jnp.int32)
    nxt_dist = jnp.concatenate([dist[1:], jnp.zeros(1, jnp.int32)])
    nxt_ml = jnp.concatenate([ml[1:], jnp.zeros(1, jnp.int32)])
    matched = ml >= MIN_MATCH
    same = matched & (nxt_ml >= MIN_MATCH) & (nxt_dist == dist)
    z = jnp.where(matched, ml + pos, _NEG)

    # manual segmented reverse Hillis-Steele: log2(n) doubling steps of
    # shifted elementwise combines (see _two_level for why not
    # jax.lax.associative_scan). Flags compose by AND along the shift.
    v, f = z, same
    d = 1
    while d < s:
        vs = jnp.concatenate([v[d:], jnp.full(d, _NEG, jnp.int32)])
        fsh = jnp.concatenate([f[d:], jnp.zeros(d, bool)])
        v = jnp.maximum(v, jnp.where(f, vs, _NEG))
        f = f & fsh
        d *= 2
    ext = jnp.minimum(jnp.minimum(v - pos, MAX_MATCH_LEN),
                      valid_len - pos)
    return jnp.where(matched, jnp.maximum(ext, 0), 0)


GRID = 256  # run-relative emission grid (must divide into MAX_MATCH_LEN-2)
TILE = 32   # long-match threshold: matches >= TILE chain on the run grid
WTILE = 64  # short-match walk tile (exact greedy within each cell)
_INF = 1 << 28            # plain int — see _NEG note
_SCAN_CHUNK = 256


def _two_level(op, x: jnp.ndarray, fill: int = -(1 << 28)) -> jnp.ndarray:
    """Inclusive forward prefix scan of an idempotent op (max/min) as a
    manual Hillis-Steele doubling loop: log2(n) shifted-combine steps of
    plain elementwise ops, which fuse into a few cheap passes (the
    generic odd-even construction of jax.lax.associative_scan was the
    slower choice where first measured). `fill` must be op's
    identity."""
    n = x.shape[0]
    d = 1
    while d < n:
        x = op(x, jnp.concatenate(
            [jnp.full(d, fill, x.dtype), x[:-d]]))
        d *= 2
    return x


def select_tokens(ml: jnp.ndarray, dist: jnp.ndarray,
                  valid_len: jnp.ndarray, wtile: int | None = None):
    """Valid non-overlapping token selection: scans + a lean 64-step walk.

    The exact greedy walk over a 64 KiB block is a 64K-step sequential
    linked-list traversal (the reference's decide_greedy_sequences,
    reference src/compress/mod.rs:1261-1373). Parallel reformulation:

    Phase 1 (long matches, pure scans): inside each same-distance run,
    cap every match at the next GRID boundary relative to the run start;
    all capped ends in a run land exactly on grid points, so selecting
    matches whose start is not covered by any earlier capped end
    (exclusive prefix-max) reproduces greedy EXACTLY for runs — the
    high-ratio case (zeros, periodic data, long repeats).

    Phase 2 (short matches, exact in-tile greedy): remaining matches are
    capped at their WTILE cell boundary and at the next phase-1 match
    start, then each cell runs the true greedy walk — a WTILE-step fori_loop
    over a lean u8 step array, entering at the cell's first byte not covered by phase 1.

    Returns (ml_emit, sel, lit): disjoint selected matches with their
    emission lengths, and the literal mask covering every remaining byte.
    """
    WTILE = wtile if wtile is not None else globals()["WTILE"]
    s = ml.shape[0]
    pos = jnp.arange(s, dtype=jnp.int32)
    in_range = pos < valid_len
    matched = (ml >= MIN_MATCH) & in_range

    # --- phase 1: run-grid chained long matches --------------------------
    prev_m = jnp.concatenate([jnp.zeros(1, bool), matched[:-1]])
    prev_d = jnp.concatenate([jnp.zeros(1, jnp.int32), dist[:-1]])
    boundary = ~(matched & prev_m & (dist == prev_d))
    run_start = _two_level(jnp.maximum, jnp.where(boundary, pos, -1))
    ml_run = jnp.minimum(ml, GRID - ((pos - run_start) % GRID))
    long_ok = matched & (ml_run >= TILE)
    raw_end = jnp.where(long_ok, pos + ml_run, 0)
    rawmax = _two_level(jnp.maximum, raw_end)
    rawmax_excl = jnp.concatenate([jnp.zeros(1, jnp.int32), rawmax[:-1]])
    sel1 = long_ok & (rawmax_excl <= pos)
    sel1_end = jnp.where(sel1, pos + ml_run, 0)
    selmax = _two_level(jnp.maximum, sel1_end)
    selmax_excl = jnp.concatenate([jnp.zeros(1, jnp.int32), selmax[:-1]])
    covered = selmax_excl > pos               # inside a phase-1 match body

    # --- phase 2: exact greedy walk per WTILE cell over the gaps ---------
    # tile-local reverse min scans as manual doubling shifts along the
    # lane axis (log2(WTILE) elementwise steps — see _two_level)
    nt = s // WTILE

    def tile_rev_min(m):
        d = 1
        while d < WTILE:
            sh = jnp.concatenate(
                [m[:, d:], jnp.full((nt, d), _INF, jnp.int32)], axis=1)
            m = jnp.minimum(m, sh)
            d *= 2
        return m

    nxt1_t = tile_rev_min(jnp.where(sel1, pos, _INF).reshape(nt, WTILE))
    nxt1 = nxt1_t.reshape(s)
    # next selected-1 position strictly after, within the cell; the cell
    # end takes INF (those positions have ml_short <= 1 anyway)
    nxt1_excl = jnp.concatenate(
        [nxt1.reshape(nt, WTILE)[:, 1:],
         jnp.full((nt, 1), _INF, jnp.int32)], axis=1).reshape(s)
    ml_short = jnp.minimum(ml, WTILE - (pos & (WTILE - 1)))
    ml_short = jnp.minimum(ml_short, nxt1_excl - pos)
    short_ok = matched & ~sel1 & ~covered & (ml_short >= MIN_MATCH)

    lane = jnp.arange(WTILE, dtype=jnp.int32)[None, :]
    # next short-match candidate at-or-after each position, tile-local
    nxt_t = jnp.clip(tile_rev_min(
        jnp.where(short_ok.reshape(nt, WTILE), lane, _INF)), 0, WTILE)
    ml_t = ml_short.reshape(nt, WTILE)
    # exact greedy walk per cell, jumping candidate-to-candidate: each
    # iteration selects one match (everything skipped in between is a
    # literal or sel1-covered byte), so the trip count is bounded by
    # WTILE/MIN_MATCH + 1 instead of WTILE. (A matrix-power
    # reachability variant is memory-bound: 16K batched 64x64
    # squarings.)
    def body(_, st):
        cur, vis, s2 = st
        cand = jnp.max(jnp.where(lane == jnp.minimum(cur, WTILE - 1)[:, None],
                                 nxt_t, 0), axis=1)
        cand = jnp.where(cur >= WTILE, WTILE, cand)
        vis = vis | ((lane >= cur[:, None]) & (lane < cand[:, None]))
        oh = lane == cand[:, None]
        s2 = s2 | oh
        ml_at = jnp.max(jnp.where(oh, ml_t, 0), axis=1)
        return (jnp.where(cand >= WTILE, WTILE, cand + ml_at), vis, s2)

    # data-dependent all-False init keeps the carry "varying" under
    # shard_map (a literal constant would be replicated and fail to match
    # the loop output's manual-axes type)
    vis0 = ml_t < 0
    cur0 = jnp.zeros(nt, jnp.int32) + (ml_t[:, 0] - ml_t[:, 0])
    _, visited, sel2_t = jax.lax.fori_loop(
        0, WTILE // MIN_MATCH + 1, body, (cur0, vis0, vis0))
    visited = visited.reshape(s)
    sel2 = sel2_t.reshape(s) & short_ok

    lit = visited & in_range & ~covered & ~sel1 & ~sel2
    sel = sel1 | sel2
    ml_emit = jnp.where(sel1, ml_run, ml_short)
    return ml_emit, sel, lit


def pack_rows(val: jnp.ndarray, nb: jnp.ndarray, start_bits,
              row_out: int = ROW_OUT):
    """Bit-pack per-lane tokens (val, nb) into globally-aligned row
    buffers (fully parallel: one cumsum + one-hot matmul word placement).

    start_bits is the global bit offset of lane 0's first bit (scalar,
    may be traced — the dynamic tier's variable-length header precedes
    the body). Returns (rows (R, row_out+1) uint8, byte_off (R,),
    row_bit0 (R,), end_bits scalar): rows OR-merge into the output at
    byte_off (consecutive rows share at most one boundary byte).
    """
    s = val.shape[0]
    assert s % ROW == 0
    r = s // ROW
    ends = jnp.cumsum(nb)
    # jnp.cumsum lowers efficiently here (unlike lax.associative_scan)
    bitpos = start_bits + ends - nb
    # row segmentation for packing: row r's base bit = bitpos of lane r*ROW
    bitpos_r = bitpos.reshape(r, ROW)
    row_bit0 = bitpos_r[:, 0]
    # each token occupies u32 words [w0, w0+1] local to its row
    word_off = row_bit0 >> 5
    local_word = (bitpos_r >> 5) - word_off[:, None]          # [0, NW)
    shift = (bitpos_r & 31).astype(U)
    v = val.reshape(r, ROW)
    lo = v << shift
    hi = jnp.where(shift == 0, U(0), v >> (U(32) - shift))
    # exact by construction: 8-bit byte planes (integers <= 255 are
    # exact in bfloat16), a one-hot operand (each output word sums
    # disjoint-bit bytes) and float32 accumulation; 16-bit parts would
    # not be exact in bfloat16.
    parts = jnp.stack(
        [((lo >> U(8 * k)) & U(0xFF)).astype(jnp.bfloat16) for k in range(4)]
        + [((hi >> U(8 * k)) & U(0xFF)).astype(jnp.bfloat16)
           for k in range(4)], axis=1)                        # (R, 8, ROW)
    nw = row_out // 4 + 2
    cols = jnp.arange(nw, dtype=jnp.int32)
    onehot = (local_word[:, :, None] == cols).astype(jnp.bfloat16)
    g = jnp.einsum("rpw,rwc->rpc", parts, onehot,
                   preferred_element_type=jnp.float32)        # (R, 8, NW)
    gb = [g[:, k].astype(jnp.int32).astype(U) for k in range(8)]
    words_lo = (gb[0] | (gb[1] << U(8)) | (gb[2] << U(16))
                | (gb[3] << U(24)))
    words_hi = (gb[4] | (gb[5] << U(8)) | (gb[6] << U(16))
                | (gb[7] << U(24)))
    # hi parts belong to the NEXT word: shift along the word axis
    words_hi = jnp.concatenate(
        [jnp.zeros((r, 1), U), words_hi[:, :-1]], axis=1)
    words = words_lo | words_hi                               # (R, NW)
    # words -> bytes (LSB-first)
    bshift = U(8) * jnp.arange(4, dtype=U)
    buf = ((words[:, :, None] >> bshift) & U(0xFF)).reshape(r, nw * 4)
    buf = buf[:, : row_out].astype(jnp.int32)

    # rows start mid-byte in general: shift each row to global alignment.
    # row_bit0 = 32*word_off + residue; the buffer currently holds bits
    # from 32*word_off, so drop (row_bit0 & 7) relative to the byte grid:
    # global byte_off = row_bit0 >> 3; buffer byte 0 corresponds to byte
    # (32*word_off)>>3 = word_off*4 which differs from byte_off by
    # delta = (row_bit0 >> 3) - word_off*4 in [0, 3]. Realign by dropping
    # `delta` leading bytes (static 4-way select, elementwise).
    byte_off = row_bit0 >> 3
    delta = byte_off - (word_off << 2)
    bufz = jnp.concatenate([buf, jnp.zeros((r, 4), jnp.int32)], axis=1)
    rows = jnp.zeros((r, row_out + 1), jnp.int32)
    for d in range(4):
        rows = jnp.where((delta == d)[:, None],
                         bufz[:, d: d + row_out + 1], rows)
    rows = rows.astype(jnp.uint8)
    return rows, byte_off, row_bit0, start_bits + ends[-1]


def encode_rows_static(data_padded: jnp.ndarray, valid_len: jnp.ndarray,
                       is_final: jnp.ndarray, block_size: int):
    """Device encoder for one padded block — fully parallel (sorts, scans,
    elementwise ops, and one-hot matmul word placement; no loops, no gathers,
    no scatters).

    Returns (rows (R, ROW_OUT+1) uint8 globally-bit-aligned row buffers,
    byte_off (R,), rowbits (R,), total_bits, nbytes).
    """
    s = block_size

    ml, dist = find_matches_v2(data_padded, valid_len, s)
    ml = extend_runs(ml, dist, valid_len)
    ml, sel, lit = select_tokens(ml, dist, valid_len)

    lv, ln = literal_code(data_padded[:s])
    mv, mn = match_token(jnp.maximum(ml, MIN_MATCH),
                         jnp.clip(dist, 1, WINDOW_SIZE))
    val = jnp.where(sel, mv, jnp.where(lit, lv, U(0)))
    nb = jnp.where(sel, mn, jnp.where(lit, ln, U(0))).astype(jnp.int32)

    # 3-bit block header precedes the body
    rows, byte_off, row_bit0, end_bits = pack_rows(val, nb, 3, ROW_OUT)
    rowbits_all = jnp.concatenate([row_bit0, end_bits[None]])
    rowbits = rowbits_all[1:] - rowbits_all[:-1]
    total_bits = end_bits + 7                      # body + EOB(7 zero bits)
    nbytes = jnp.where(
        is_final,
        (total_bits + 7) // 8,
        (total_bits + 3 + 7) // 8 + 4)             # SYNC: 3-bit hdr + 0000FFFF
    return rows, byte_off, rowbits, total_bits, nbytes


@functools.lru_cache(maxsize=8)
def jit_encoder(block_size: int):
    f = functools.partial(encode_rows_static, block_size=block_size)
    return jax.jit(jax.vmap(f, in_axes=(0, 0, 0)))


@functools.lru_cache(maxsize=8)
def jit_encoder_scan(block_size: int, unroll: int = 8):
    """Encoder over (k, B, S+PAD) chunked batches: an UNROLLED loop of
    independent chunk subgraphs inside one jit.

    Separate dispatches of small programs do not overlap one another;
    XLA can interleave independent subgraphs WITHIN one program, hiding
    each chunk's long dependency chain (sorts + scans) behind its
    neighbors'. lax.scan would re-serialize them; a python loop in the
    traced function keeps them independent."""
    f = jax.vmap(functools.partial(encode_rows_static,
                                   block_size=block_size))

    def run(blocks, valids, finals):
        outs = [f(blocks[i], valids[i], finals[i]) for i in range(unroll)]
        return tuple(jnp.stack([o[j] for o in outs]) for j in range(5))

    return jax.jit(run)


def assemble_blocks(rows: np.ndarray, byte_off: np.ndarray,
                    rowbits: np.ndarray, total_bits: np.ndarray,
                    nbytes: np.ndarray, finals: np.ndarray,
                    num: int, out_cap: int) -> list[bytes]:
    """Host-side ragged placement of device row buffers into final streams.

    Interior bytes of each row never collide across rows (consecutive rows
    share at most one boundary byte), so they go in with one vectorized
    fancy assignment; the first/last byte of each row and the 3-bit block
    header are OR-accumulated. The EOB is the static code 0000000 (zero
    bits — length arithmetic only); non-final blocks append the SYNC empty
    stored block 00 00 FF FF (reference src/compress/mod.rs:662-681).
    """
    b, r, w = rows.shape
    out = np.zeros((b, out_cap), dtype=np.uint8)
    # bytes spanned by each row's bits depend on its in-byte start phase:
    # phase_r = bitstart_r & 7 where bitstart_r = 3 + cumsum(rowbits)_{<r}
    cs = np.zeros((b, r), np.int64)
    cs[:, 1:] = np.cumsum(rowbits[:, :-1], axis=1)
    phase = (3 + cs) & 7
    extent = (phase + rowbits + 7) // 8            # bytes used per row
    extent = np.minimum(extent, w)

    from ..native import assemble_rows_native
    if not assemble_rows_native(out, rows, byte_off, extent):
        # numpy fallback: interior bytes never collide across rows
        # (consecutive rows share at most one boundary byte), so one
        # fancy assignment + OR-accumulate for the boundary bytes
        kk = np.arange(w)[None, None, :]
        gidx = byte_off[:, :, None] + kk           # (B, R, W) global bytes
        interior = (kk >= 1) & (kk < extent[:, :, None] - 1)
        bidx = np.broadcast_to(np.arange(b)[:, None, None], gidx.shape)
        out[bidx[interior], gidx[interior]] = rows[interior]
        boundary = ((kk == 0) | (kk == extent[:, :, None] - 1)) & \
            (kk < extent[:, :, None])
        np.bitwise_or.at(out, (bidx[boundary], gidx[boundary]),
                         rows[boundary])
    # 3-bit block header: BFINAL | BTYPE=01 (LSB-first)
    for i in range(num):
        out[i, 0] |= (1 if finals[i] else 0) | 0b010
        if not finals[i]:
            nb = int(nbytes[i])
            out[i, nb - 2] = 0xFF
            out[i, nb - 1] = 0xFF
            out[i, nb - 3] = 0x00
            out[i, nb - 4] = 0x00
    return [out[i, : int(nbytes[i])].tobytes() for i in range(num)]


def deflate_device_static_v2(data: bytes, block_size: int = 65536) -> bytes:
    """Whole-buffer raw-DEFLATE encode on the device (level-1 tier)."""
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
    enc = jit_encoder(block_size)
    rows, byte_off, rowbits, total_bits, nbytes = enc(
        jnp.asarray(arr), jnp.asarray(valid), jnp.asarray(finals))
    out_cap = int(block_size * 1.25) + 64
    parts = assemble_blocks(
        np.asarray(rows), np.asarray(byte_off).astype(np.int64),
        np.asarray(rowbits).astype(np.int64),
        np.asarray(total_bits), np.asarray(nbytes), finals, num, out_cap)
    return b"".join(parts)
