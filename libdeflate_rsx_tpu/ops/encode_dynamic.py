"""Device dynamic-Huffman DEFLATE block encoder (per-block code tables).

The static tier (ops/encode_v2.py) trades ratio for zero table state; this
tier adds per-block dynamic Huffman coding — the reference's dynamic-block
path (reference src/compress/mod.rs:1775-1883 header construction,
:509-541 per-block code tables) re-split for a device execution model:

  jit A  analyze_block — the shared match pipeline (sort matchfinder,
         run extension, token selection) plus per-block litlen/offset
         symbol HISTOGRAMS, computed as one extra sort + searchsorted
         (no scatter-add: binning 64K symbols into 288 bins is a sorted
         run-length count).
  host   dyn_tables_c (native/codec.c) — histograms (288+30 u32 per
         block, a few KB over the link) become optimal length-limited
         canonical code tables + the serialized dynamic header via
         package-merge; microseconds per block in C.
  jit B  emit_pack — tokens are coded through the per-block tables (two
         64K-element gathers — the one place gather wins: 288-entry
         tables stay in fast memory) and bit-packed by the shared
         pack_rows matmul packer, starting at the header's bit length.

A match token can exceed 32 bits under dynamic codes (15+5 length part,
15+13 offset part), so it is emitted as TWO lanes: the length part at the
match position p, the offset part at p+1 (always a covered lane: matches
are >= 4 long, so p+1 carries no token of its own). The cumsum in
pack_rows then interleaves them in exactly DEFLATE's required order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..common import WINDOW_SIZE
from .encode_v2 import (
    MIN_MATCH,
    extend_runs,
    find_matches_v2,
    pack_rows,
    select_tokens,
)
from .static_codes import length_sym_fields, offset_sym_fields

U = jnp.uint32
ROW_OUT_DYN = 64      # 32 lanes x <=15-bit literals = 480 bits = 60 B max
NUM_LITLEN = 288
NUM_OFFSET = 30
_NOSYM_LL = NUM_LITLEN      # histogram discard bin
_NOSYM_OF = NUM_OFFSET


def _hist(sym: jnp.ndarray, nbins: int) -> jnp.ndarray:
    """Fixed-bin histogram without scatter-add: sort + run boundaries.
    `sym` may contain values == nbins (discard bin, not counted)."""
    ss = jnp.sort(sym)
    edges = jnp.arange(nbins + 1, dtype=sym.dtype)
    idx = jnp.searchsorted(ss, edges, side="left")
    return (idx[1:] - idx[:-1]).astype(jnp.int32)


def analyze_block(data_padded: jnp.ndarray, valid_len: jnp.ndarray,
                  block_size: int):
    """Match pipeline + per-block symbol histograms.

    Returns (ml, dist, sel, lit, ll_hist (288,), of_hist (30,)); the
    token arrays stay on device as inputs to emit_pack."""
    s = block_size
    ml, dist = find_matches_v2(data_padded, valid_len, s)
    ml = extend_runs(ml, dist, valid_len)
    ml, sel, lit = select_tokens(ml, dist, valid_len)

    lsym, _, _ = length_sym_fields(jnp.maximum(ml, MIN_MATCH))
    dsym, _, _ = offset_sym_fields(jnp.clip(dist, 1, WINDOW_SIZE))
    byte = data_padded[:s].astype(jnp.int32)
    hsym = jnp.where(sel, lsym, jnp.where(lit, byte, _NOSYM_LL))
    # saturating uint16 counts halve the histogram bytes crossing the
    # host link (the package-merge weights only need relative magnitude;
    # saturation at 65535 on a 64 KiB block is lossless in practice)
    ll_hist = jnp.minimum(_hist(hsym, NUM_LITLEN), 65535
                          ).astype(jnp.uint16)
    of_hist = jnp.minimum(_hist(jnp.where(sel, dsym, _NOSYM_OF),
                                NUM_OFFSET), 65535).astype(jnp.uint16)
    return ml, dist, sel, lit, ll_hist, of_hist


def emit_pack(data_padded: jnp.ndarray, ml: jnp.ndarray, dist: jnp.ndarray,
              sel: jnp.ndarray, lit: jnp.ndarray, ll_tab: jnp.ndarray,
              of_tab: jnp.ndarray, start_bits: jnp.ndarray,
              block_size: int):
    """Code the selected tokens through per-block tables and bit-pack.

    ll_tab (288,) / of_tab (30,): uint32 entries `code | len << 16`
    (codes bit-reversed for LSB-first emission). start_bits: bit length
    of the block's serialized header (body starts there).

    Returns (rows, byte_off, row_bit0, end_bits) from pack_rows."""
    s = block_size
    byte = data_padded[:s].astype(jnp.int32)
    lsym, lev, leb = length_sym_fields(jnp.maximum(ml, MIN_MATCH))
    dsym, dev, deb = offset_sym_fields(jnp.clip(dist, 1, WINDOW_SIZE))

    # litlen lane: literal byte or match-length symbol (+ extra bits)
    ent = ll_tab[jnp.where(sel, lsym, byte)]
    code = ent & U(0xFFFF)
    clen = ent >> U(16)
    val = code | (jnp.where(sel, lev, U(0)) << clen)
    nb = clen + jnp.where(sel, leb, U(0))
    active = sel | lit
    val = jnp.where(active, val, U(0))
    nb = jnp.where(active, nb, U(0)).astype(jnp.int32)

    # offset part rides the (always covered) next lane
    dent = of_tab[dsym]
    dcode = dent & U(0xFFFF)
    dlen = dent >> U(16)
    dval = jnp.where(sel, dcode | (dev << dlen), U(0))
    dnb = jnp.where(sel, dlen + deb, U(0)).astype(jnp.int32)
    val = val | jnp.concatenate([jnp.zeros(1, U), dval[:-1]])
    nb = nb + jnp.concatenate([jnp.zeros(1, jnp.int32), dnb[:-1]])

    return pack_rows(val, nb, start_bits, ROW_OUT_DYN)


# ---------------------------------------------------------------------------
# L6 tier: strided prefix ladder + 32 KiB cross-block history
# ---------------------------------------------------------------------------
# Measured design (scripts/eval_matchfinder.py, silesia-like corpus):
# the nearest-previous-occurrence matchfinder alone tops out at ratio
# ~2.65; history carry recovers the zlib-chunking gap (+5.5%), tiered
# longer-prefix candidates close the long-match members (nci 7.1->10.1),
# and lazy demotion + 256-wide greedy cells close the selection gap.
# Strides keep the tier sorts affordable: a match of length >= L +
# stride - 1 always covers a stride grid point, so tier (L, stride)
# sorts only s/stride elements.

HIST = WINDOW_SIZE          # cross-block history prefix (bytes)
L6_LEVELS = (16, 32, 64)    # rank-ladder candidate levels (bytes)
L6_TIER_K = 6               # predecessors per ladder level (measured:
                            # 2 -> 6 with base k=4 buys ~+1% ratio on
                            # every silesia member at elementwise cost)
L6_GRID = 2                 # ladder grid stride (bytes)
WTILE_L6 = 256              # selection cell (ops/encode_v2.select_tokens)


def _words_at(data_padded: jnp.ndarray, off: int, s: int) -> jnp.ndarray:
    d = data_padded.astype(U)
    return (d[off:off + s] | (d[off + 1:off + 1 + s] << U(8))
            | (d[off + 2:off + 2 + s] << U(16))
            | (d[off + 3:off + 3 + s] << U(24)))


def _prefix_bytes(x):
    b0 = (x & U(0xFF)) == 0
    b1 = (x & U(0xFFFF)) == 0
    b2 = (x & U(0xFFFFFF)) == 0
    return (b0.astype(jnp.int32) + b1.astype(jnp.int32)
            + b2.astype(jnp.int32))


def _ml_from_xors(xs):
    """Exact common-prefix length 0..4*len(xs) from per-word XORs."""
    total = jnp.zeros_like(xs[0], dtype=jnp.int32)
    alive = jnp.ones(xs[0].shape, bool)
    for x in xs:
        step = jnp.where(x == 0, 4, _prefix_bytes(x))
        total = total + jnp.where(alive, step, 0)
        alive = alive & (x == 0)
    return total


def _merge_cand(ml_new, dist_new, best_ml, best_dist):
    better = (ml_new > best_ml) | ((ml_new == best_ml)
                                   & (dist_new < best_dist)
                                   & (ml_new > 0))
    return (jnp.where(better, ml_new, best_ml),
            jnp.where(better, dist_new, best_dist))


def _two_level_u32max(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive forward prefix max (manual doubling — see
    encode_v2._two_level for why not lax.associative_scan/cumsum)."""
    n = x.shape[0]
    d = 1
    while d < n:
        x = jnp.maximum(x, jnp.concatenate(
            [jnp.zeros(d, x.dtype), x[:-d]]))
        d *= 2
    return x


def find_matches_l6(data_padded: jnp.ndarray, valid_len: jnp.ndarray,
                    hist_start: jnp.ndarray, s: int,
                    levels=L6_LEVELS, tier_k: int = L6_TIER_K,
                    k: int = 4):
    """(ml, dist) per position over a [history | payload] window.

    Base: one stable sort on the 4-byte word carrying pos + 3 next
    words (exact lengths to 16) with `k` predecessors. Long matches:
    a PREFIX-DOUBLING RANK LADDER on a stride-2 grid — rank_{2L}[j] is
    the dense rank of (rank_L[j], rank_L[j + L/2]), so each level is
    one 2-KEY sort (a direct 16-word lexicographic sort of the 64-byte
    prefix made XLA's comparator lowering explode: 525 s of compile for
    that one sort; the whole ladder compiles in a fraction of that).
    Each level's sorted pass extracts `tier_k` nearest-previous
    candidates sharing >= L bytes, exact to L + 8 via two carried
    words. A covering decay scan spreads grid candidates to every
    position they cover (no sorts/gathers). Candidates are rejected
    when they start before hist_start (bytes before the stream's real
    beginning: the first block has no history).
    """
    # the covering-decay scan packs (match end << 15 | nearness) into
    # uint32; match end can reach s + max(levels) + 8, so s must stay
    # below 2^17 or the packed key wraps and the prefix-max scan
    # silently emits bogus matches
    slack = max(max(levels) + 8, 258)
    if s + slack >= (1 << 17):
        raise ValueError(
            f"find_matches_l6 window {s} too large: HIST + block_size"
            f" + {slack} must stay < {1 << 17} (use block_size <="
            f" {(1 << 17) - HIST - slack - 1})")
    pos = jnp.arange(s, dtype=jnp.int32)

    def shift(a, j):
        return jnp.concatenate([a[:j] * 0, a[:-j]])

    # --- base tier: 4-byte key, k predecessors, exact <= 16 ----------------
    w0 = _words_at(data_padded, 0, s)
    ws = [_words_at(data_padded, 4 * (j + 1), s) for j in range(3)]
    ops = jax.lax.sort((w0, pos, *ws), dimension=0, num_keys=1,
                       is_stable=True)
    w0s, poss, wss = ops[0], ops[1], ops[2:]
    acc_ml = jnp.zeros(s, jnp.int32)
    acc_d = jnp.zeros(s, jnp.int32)
    for j in range(1, k + 1):
        same = (shift(w0s, j) == w0s) & (shift(pos, j) >= j)
        cand = shift(poss, j)
        dist = poss - cand
        ok = same & (dist >= 1) & (dist <= WINDOW_SIZE) \
            & (cand >= hist_start)
        xs = [w ^ shift(w, j) for w in wss]
        ml = 4 + _ml_from_xors(xs)
        ml = jnp.where(ok, ml, 0)
        dist = jnp.where(ok, dist, 0)
        acc_ml, acc_d = _merge_cand(ml, dist, acc_ml, acc_d)
    # int32 like the permutation key (see ops/encode_v2.find_matches_v2)
    packed = acc_d | (acc_ml << 20)
    _, packed_u = jax.lax.sort((poss, packed), dimension=0, num_keys=1)
    best_ml = packed_u >> 20
    best_dist = packed_u & 0xFFFFF

    # --- prefix-doubling rank ladder (stride-2 grid) ------------------------
    GS = L6_GRID
    assert s % GS == 0
    m = s // GS
    gidx = jnp.arange(m, dtype=jnp.int32)

    def shiftm(a, j):
        return jnp.concatenate([a[:j] * 0, a[:-j]])

    def ahead(r, d):
        # unique negative tail labels: rank equality past the grid end
        # must never be claimed (a shared sentinel would assert L-byte
        # equality of positions whose real bytes differ)
        pad = -(jnp.arange(d, dtype=jnp.int32) + 2)
        return jnp.concatenate([r[d:], pad])

    def ladder_pass(keyA, keyB, L):
        """One ladder level: sort by (keyA, keyB); equal pairs share an
        L-byte prefix. Returns (dense rank of the pair in grid order,
        (ml, dist) candidates in grid order; ml exact to L + 8)."""
        c0 = _words_at(data_padded, L, s)[::GS]
        c1 = _words_at(data_padded, L + 4, s)[::GS]
        srt = jax.lax.sort((keyA, keyB, gidx, c0, c1), dimension=0,
                           num_keys=2, is_stable=True)
        kAs, kBs, gs, c0s, c1s = srt
        t_ml = jnp.zeros(m, jnp.int32)
        t_d = jnp.zeros(m, jnp.int32)
        for j in range(1, tier_k + 1):
            same = (shiftm(kAs, j) == kAs) & (shiftm(kBs, j) == kBs) \
                & (gidx >= j)
            cand = shiftm(gs, j) * GS
            dist = gs * GS - cand
            ok = same & (dist >= 1) & (dist <= WINDOW_SIZE) \
                & (cand >= hist_start)
            xs = [c0s ^ shiftm(c0s, j), c1s ^ shiftm(c1s, j)]
            ml = L + _ml_from_xors(xs)
            ml = jnp.where(ok, ml, 0)
            dist = jnp.where(ok, dist, 0)
            t_ml, t_d = _merge_cand(ml, dist, t_ml, t_d)
        # dense rank of (keyA, keyB) for the next level, plus the
        # candidate scatter back to grid order, in one invert sort
        neq = (kAs != shiftm(kAs, 1)) | (kBs != shiftm(kBs, 1)) \
            | (gidx == 0)
        rank_sorted = jnp.cumsum(neq.astype(jnp.int32))
        packed = t_d | (t_ml << 20)         # int32, as above
        _, rank_g, packed_g = jax.lax.sort(
            (gs, rank_sorted, packed), dimension=0, num_keys=1)
        ml_g = packed_g >> 20
        dist_g = packed_g & 0xFFFFF
        return rank_g, ml_g, dist_g

    # rank of the 8-byte prefix on the grid (no candidate extraction:
    # the base tier already covers lengths <= 16 at stride 1)
    w0g = w0[::GS]
    w4g = _words_at(data_padded, 4, s)[::GS]
    srt8 = jax.lax.sort((w0g, w4g, gidx), dimension=0, num_keys=2,
                        is_stable=True)
    neq8 = (srt8[0] != shiftm(srt8[0], 1)) \
        | (srt8[1] != shiftm(srt8[1], 1)) | (gidx == 0)
    _, rank = jax.lax.sort(
        (srt8[2], jnp.cumsum(neq8.astype(jnp.int32))),
        dimension=0, num_keys=1)
    half = 8 // GS
    for L in levels:                   # 16, 32, 64: key = the pair of
        keyB = ahead(rank, half)       # half-prefix ranks
        rank, ml_g, dist_g = ladder_pass(rank, keyB, L)
        half = L // GS
        ml_f = jnp.zeros((m, GS), jnp.int32).at[:, 0].set(
            ml_g).reshape(s)
        dist_f = jnp.zeros((m, GS), jnp.int32).at[:, 0].set(
            dist_g).reshape(s)
        best_ml, best_dist = _merge_cand(ml_f, dist_f, best_ml,
                                         best_dist)

    # --- covering decay: spread long candidates to covered positions -------
    # value = match end (ml + pos) in the high bits, nearness in the low
    # 15 (ties prefer smaller dist); one doubling max-scan.
    end = jnp.where(best_ml >= MIN_MATCH, best_ml + pos, 0)
    packed = (end.astype(U) << U(15)) \
        | (U(32768) - jnp.clip(best_dist, 1, 32768).astype(U))
    packed = jnp.where(best_ml >= MIN_MATCH, packed, U(0))
    cov = _two_level_u32max(packed)
    cov_end = (cov >> U(15)).astype(jnp.int32)
    cov_d = (U(32768) - (cov & U(0x7FFF))).astype(jnp.int32)
    cov_ml = cov_end - pos
    use = (cov_ml > best_ml) & (cov_ml >= MIN_MATCH)
    best_ml = jnp.where(use, cov_ml, best_ml)
    best_dist = jnp.where(use, cov_d, best_dist)

    best_ml = jnp.minimum(best_ml, jnp.clip(valid_len - pos, 0, 258))
    best_ml = jnp.where(best_ml >= MIN_MATCH, best_ml, 0)
    return best_ml, best_dist


def analyze_block_l6(data_padded: jnp.ndarray, valid_len: jnp.ndarray,
                     hist_start: jnp.ndarray, block_size: int):
    """L6 match pipeline over [32 KiB history | payload] + payload-region
    histograms. data_padded: (HIST + block_size + BLOCK_PAD,) uint8;
    valid_len counts history + payload bytes; hist_start is the first
    REAL history byte (HIST for the stream's first block, 0 after).

    Returns payload-sliced (ml, dist, sel, lit, ll_hist, of_hist)."""
    from .encode_v2 import select_tokens
    s = HIST + block_size
    ml, dist = find_matches_l6(data_padded, valid_len, hist_start, s)
    ml = extend_runs(ml, dist, valid_len)
    posv = jnp.arange(s, dtype=jnp.int32)
    # history region emits nothing (the previous block covered it)
    ml = jnp.where(posv >= HIST, ml, 0)
    # one-position lazy demotion (the host greedy's lazy rule)
    nxt = jnp.concatenate([ml[1:], jnp.zeros(1, jnp.int32)])
    ml = jnp.where((nxt > ml) & (ml >= MIN_MATCH) & (nxt >= MIN_MATCH),
                   0, ml)
    ml, sel, lit = select_tokens(ml, dist, valid_len, wtile=WTILE_L6)

    ml = ml[HIST:]
    dist = dist[HIST:]
    sel = sel[HIST:]
    lit = lit[HIST:]
    lsym, _, _ = length_sym_fields(jnp.maximum(ml, MIN_MATCH))
    dsym, _, _ = offset_sym_fields(jnp.clip(dist, 1, WINDOW_SIZE))
    byte = data_padded[HIST:HIST + block_size].astype(jnp.int32)
    hsym = jnp.where(sel, lsym, jnp.where(lit, byte, _NOSYM_LL))
    ll_hist = jnp.minimum(_hist(hsym, NUM_LITLEN), 65535
                          ).astype(jnp.uint16)
    of_hist = jnp.minimum(_hist(jnp.where(sel, dsym, _NOSYM_OF),
                                NUM_OFFSET), 65535).astype(jnp.uint16)
    return ml, dist, sel, lit, ll_hist, of_hist


@functools.lru_cache(maxsize=8)
def jit_analyze_l6(block_size: int):
    f = functools.partial(analyze_block_l6, block_size=block_size)
    return jax.jit(jax.vmap(f, in_axes=(0, 0, 0)))


@functools.lru_cache(maxsize=8)
def jit_analyze(block_size: int):
    f = functools.partial(analyze_block, block_size=block_size)
    return jax.jit(jax.vmap(f, in_axes=(0, 0)))


@functools.lru_cache(maxsize=8)
def jit_emit(block_size: int):
    f = functools.partial(emit_pack, block_size=block_size)
    return jax.jit(jax.vmap(f, in_axes=(0,) * 8))


def build_tables_host(ll_hist, of_hist, finals: np.ndarray):
    """Histograms -> (ll_tabs (B,288) u32, of_tabs (B,30) u32,
    headers list[bytes], hdr_bits (B,) int32) from the native C builder
    (dyn_tables_c).

    Accepts device arrays: both histograms come down in one transfer
    rather than two sequential round trips."""
    import jax

    ll_hist, of_hist = (np.asarray(x).astype(np.uint32) for x in
                        jax.device_get((ll_hist, of_hist)))
    from ..native import dyn_tables_native
    b = ll_hist.shape[0]
    ll_tabs = np.zeros((b, NUM_LITLEN), np.uint32)
    of_tabs = np.zeros((b, NUM_OFFSET), np.uint32)
    headers: list[bytes] = []
    hdr_bits = np.zeros(b, np.int32)
    for i in range(b):
        ll_tabs[i], of_tabs[i], hdr, hdr_bits[i] = dyn_tables_native(
            ll_hist[i], of_hist[i], bool(finals[i]))
        headers.append(hdr)
    return ll_tabs, of_tabs, headers, hdr_bits


def _build_tables_py(ll_hist: np.ndarray, of_hist: np.ndarray,
                     final: bool):
    """Pure-Python mirror of native dyn_tables_c: the tests' oracle."""
    from ..models.portable.deflate import (
        TokenStream,
        _dynamic_header_tokens,
        _ensure_complete,
    )
    from ..models.portable.huffman import canonical_codes, make_huffman_code

    llf = ll_hist.astype(np.int64).copy()
    llf[256] += 1
    # litlen limited to 14 bits (matches native MAX_LL_LEN and the
    # reference's limit, src/compress/mod.rs:127-129, so fused
    # multi-symbol emit writes fit fixed-width words); offsets 15.
    ll_lens, _ = make_huffman_code(llf, 14)
    of_lens, _ = make_huffman_code(of_hist.astype(np.int64), 15)
    ll_lens = _ensure_complete(ll_lens)
    of_lens = _ensure_complete(of_lens)
    ll_codes = canonical_codes(ll_lens)
    of_codes = canonical_codes(of_lens)
    ts = TokenStream(0)
    ts.put((1 if final else 0) | 0b100, 3)         # BFINAL | BTYPE=10
    values, nbits, _ = _dynamic_header_tokens(ll_lens, of_lens)
    ts.put_arrays(values, nbits)
    hdr = ts.pack()
    bits = ts.bitcount
    ll_tab = ll_codes.astype(np.uint32) | (ll_lens.astype(np.uint32) << 16)
    of_tab = (of_codes[:NUM_OFFSET].astype(np.uint32)
              | (of_lens[:NUM_OFFSET].astype(np.uint32) << 16))
    return ll_tab, of_tab, hdr, bits
