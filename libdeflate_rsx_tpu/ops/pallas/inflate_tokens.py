"""Pass 1 of the batch DEFLATE decoder: lockstep entropy decode on the GPU.

Every stream of a batch is one lane of a lane vector. One Pallas program
(Triton route) decodes `lanes` streams together, one symbol step per
loop iteration, and stores one int32 token per lane per step at
`tok[step, stream]` (ops/tokens.py format). Pass 2 (LZ copy resolution)
is the native C resolver on the host pool or ops/resolve.py on the
device. This is the GPU design of the reference's per-thread batch
decode (reference src/batch.rs:74-101) and its table-driven symbol loop
(reference src/decompress/mod.rs:509-1072).

Per lane, a mode machine walks the stream: block header, precode
lengths, code-length RLE, waiting for a table build, block body, stored
bytes, done, bad.

- Bit buffer: 64 bits as two uint32 words; each refill is one indexed
  load of the lane's next word from the flat (streams, words) input.
- Huffman decode is canonical arithmetic: bit-reverse 15 peeked bits,
  compare them with the code's 16 MSB-aligned limits (one (lanes, 16)
  load), then load the base-first offset and the symbol permutation.
  Tables live in one ROW-int row per lane of a device scratch buffer;
  the static-Huffman tables and the precode order live in one shared
  row after the lane rows, chosen per lane by a table base.
- A lane that finished its code lengths enters AWAITBUILD, and one
  masked build in the same step serves every lane of the program that
  did so. A build counts code lengths
  into a (lanes, 16) register block, turns them into limits and offsets
  with two prefix sums, and places symbols with one pass over them.
- Masked-off lanes write to a trash slot of their own row, so every
  store is unconditional. A block barrier closes each build: the
  lanes' table rows are written and read by different threads.

Streams over the input cap, malformed streams and streams that do not
finish within the step budget end in a mode other than DONE; callers
decode those items on the host (the reference's graceful-fallback
pattern, src/batch.rs:23-27).

Interpret mode (`interpret=True`) runs the same kernel in the Pallas
interpreter and exists for the CPU tests. Without it the kernel needs a
CUDA GPU and raises on any other backend.
"""

from __future__ import annotations

import functools

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental.pallas import triton as plgpu

from ..tokens import KIND_LIT, KIND_MATCH, KIND_SHIFT

IN_CAP = 65536              # compressed bytes per stream (default bucket)
OUT_CAP = 65536             # decoded bytes per stream (default bucket)
MAX_LANES = 32              # most streams per program
MAX_PROGRAMS = 4096         # about one wave of one-warp programs on an
                            # H100 (132 SMs x 32 resident blocks)
NUM_WARPS = 1

# lane modes (active = mode < DONE)
BLKSTART, PRELEN, LENS, AWAITBUILD, BODY, STORED, DONE, BAD = range(8)

# rows of the stats output
S_MODE, S_OUTPOS, S_DONESTEP, S_BITPOS, S_LASTSTEP = range(5)
NSTATS = 5

# int32 offsets inside a table row; the last row of the scratch buffer
# holds the static tables at the same offsets plus the precode order
ROW = 1024
T_LENS = 0                  # 288 litlen + 32 distance code lengths
T_PLENS = 320               # 19 precode lengths, by symbol
T_LL_LIM, T_LL_FB = 352, 368
T_OF_LIM, T_OF_FB = 384, 400
T_PRE_LIM, T_PRE_FB = 416, 432
T_LL_PERM = 448             # 288 symbols sorted by (length, symbol)
T_OF_PERM = 736             # 32
T_PRE_PERM = 768            # 19 (32)
T_ORDER = 800               # static row: RFC 1951 3.2.7 length order
T_INV_ORDER = 832           # static row: position of a symbol in it
T_TRASH = 1008              # 16 slots for masked-off stores

# precode length order (RFC 1951 3.2.7)
CLCL_ORDER = np.array([16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3,
                       13, 2, 14, 1, 15], np.int32)


def canonical_tables(lens, nperm: int):
    """Host mirror of the in-kernel build: code lengths -> (lim (16,)
    MSB-aligned limits with lim[0] unused and huge, fb (16,) = base
    index - first code, perm (nperm,) symbols sorted by (length,
    symbol))."""
    lens = np.asarray(lens, np.int64)
    cnt = np.bincount(lens, minlength=16)[:16]
    cnt[0] = 0
    w = cnt << (15 - np.arange(16))
    incl = np.cumsum(w)
    first = (incl - w) >> (15 - np.arange(16))
    bidx = np.cumsum(cnt) - cnt
    lim = incl.copy()
    lim[0] = 1 << 29
    perm = np.zeros(nperm, np.int64)
    used = [s for s in sorted(range(len(lens)), key=lambda s: (lens[s], s))
            if lens[s]]
    perm[:len(used)] = used
    return (lim.astype(np.int32), (bidx - first).astype(np.int32),
            perm.astype(np.int32))


def _static_row() -> np.ndarray:
    row = np.zeros(ROW, np.int32)
    ll = canonical_tables([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, 288)
    of = canonical_tables([5] * 32, 32)
    for (lim, fb, perm), (o_lim, o_fb, o_perm) in (
            (ll, (T_LL_LIM, T_LL_FB, T_LL_PERM)),
            (of, (T_OF_LIM, T_OF_FB, T_OF_PERM))):
        row[o_lim:o_lim + 16] = lim
        row[o_fb:o_fb + 16] = fb
        row[o_perm:o_perm + len(perm)] = perm
    row[T_ORDER:T_ORDER + 19] = CLCL_ORDER
    row[T_INV_ORDER:T_INV_ORDER + 19] = np.argsort(CLCL_ORDER)
    return row


_STATIC_ROW = _static_row()


# ---------------------------------------------------------------- helpers
def _shl(x, s):
    """x << s for uint32 x, s; s >= 32 gives 0."""
    return jnp.where(s >= 32, jnp.uint32(0), x << (s & 31))


def _shr(x, s):
    return jnp.where(s >= 32, jnp.uint32(0), x >> (s & 31))


def _rev15(x):
    """Bit-reverse the low 15 bits of each int32 lane."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def _count(mask):
    return jnp.sum(mask.astype(jnp.int32))


def _len_extra(sym):
    """Litlen symbol (257..285) -> (extra_bits, base_len). Closed form
    of the RFC 1951 3.2.5 table."""
    ls = sym - 257
    eb = jnp.where(ls < 8, 0, jnp.where(ls == 28, 0, (ls >> 2) - 1))
    base = jnp.where(ls < 8, ls + 3,
                     jnp.where(ls == 28, 258, ((4 + (ls & 3)) << eb) + 3))
    return eb, base


def _dist_extra(dsym):
    """Distance symbol (0..29) -> (extra_bits, base_dist)."""
    deb = jnp.maximum((dsym >> 1) - 1, 0)
    dbase = jnp.where(dsym < 4, dsym + 1, ((2 + (dsym & 1)) << deb) + 1)
    return deb, dbase


# ------------------------------------------------------------ lane decoder
def _decode_lanes(inbits_ref, words_ref, tab, tok_ref, stats_ref, base,
                 lanes: int, *, npad: int, in_words: int, max_steps: int,
                 out_cap: int, barrier: bool):
    """Decode streams base .. base+lanes-1 of the batch.

    inbits_ref (npad,) input bits per stream; words_ref (npad *
    in_words,) input words; tab ((npad + 1) * ROW,) table rows, the
    last one holding _STATIC_ROW; tok_ref (max_steps, npad); stats_ref
    (NSTATS, npad). barrier: fence each table build with block barriers
    (the compiled kernel; the interpreter runs lanes in one thread).
    """
    I, U = jnp.int32, jnp.uint32
    lane = base + lax.broadcasted_iota(I, (lanes,), 0)
    row = lane * ROW
    srow = npad * ROW
    wrow = lane * in_words
    trash = row + T_TRASH
    col = lax.broadcasted_iota(I, (lanes, 16), 1)
    inbits = inbits_ref[lane]

    def zeros():
        return jnp.zeros((lanes,), I)

    def sync():
        if barrier:
            plgpu.debug_barrier()

    def put(idx, val, m):
        tab[jnp.where(m, idx, trash)] = jnp.broadcast_to(val, (lanes,))

    def put16(off, val, m):
        tab[jnp.where(m[:, None], row[:, None] + off, trash[:, None]) + col] \
            = val

    # ---- bit buffer: s["lo"], s["hi"] uint32; nbits bits buffered;
    # bitpos bits consumed; bitpos + nbits is a multiple of 32
    def refill(s):
        nbits = s["nbits"]
        need = nbits <= 32
        wf = (s["bitpos"] + nbits) >> 5
        w = lax.bitcast_convert_type(
            words_ref[wrow + jnp.clip(wf, 0, in_words - 1)], U)
        nb = nbits.astype(U)
        return dict(s,
                    lo=jnp.where(need, s["lo"] | _shl(w, nb), s["lo"]),
                    hi=jnp.where(need, s["hi"] | _shr(w, U(32) - nb),
                                 s["hi"]),
                    nbits=jnp.where(need, nbits + 32, nbits))

    def consume(s, n):
        nu = n.astype(U)
        return dict(s, lo=_shr(s["lo"], nu) | _shl(s["hi"], U(32) - nu),
                    hi=_shr(s["hi"], nu), nbits=s["nbits"] - n,
                    bitpos=s["bitpos"] + n)

    def bits(x, n):
        mask = jnp.where(n >= 32, U(0xFFFFFFFF),
                         _shl(jnp.full((lanes,), 1, U), n.astype(U)) - U(1))
        return (x & mask).astype(I)

    def decode(lo, tb, lim_off, fb_off, perm_off, nperm):
        """One canonical-Huffman decode -> (sym, code_len, bad)."""
        v15 = _rev15((lo & U(0x7FFF)).astype(I))
        lim = tab[tb[:, None] + lim_off + col]
        length = 1 + jnp.sum((v15[:, None] >= lim).astype(I), axis=1)
        lc = jnp.clip(length, 1, 15)
        off = (v15 >> (15 - lc)) + tab[tb + fb_off + lc]
        sym = tab[tb + perm_off + jnp.clip(off, 0, nperm - 1)]
        return sym, lc, length >= 16

    def build(m, lens_off, nsym, valid, lim_off, fb_off, perm_off, nperm):
        """Masked canonical-code build for lanes in m; -> over-subscribed
        flag per lane."""
        sync()

        def length(sym):
            return jnp.where(valid(sym) & m, tab[row + lens_off + sym], 0)

        cnt = lax.fori_loop(
            0, nsym,
            lambda sym, c: c + (col == length(sym)[:, None]).astype(I),
            jnp.zeros((lanes, 16), I))
        cnt = jnp.where(col == 0, 0, cnt)
        w = cnt << (15 - col)
        incl = lax.cumsum(w, axis=1)
        first = (incl - w) >> (15 - col)
        bidx = lax.cumsum(cnt, axis=1) - cnt
        put16(lim_off, jnp.where(col == 0, 1 << 29, incl), m)
        put16(fb_off, bidx - first, m)

        def place(sym, nxt):
            ln = length(sym)
            hit = (col == ln[:, None]) & (ln > 0)[:, None]
            pos = jnp.sum(jnp.where(hit, nxt, 0), axis=1)
            put(row + perm_off + jnp.clip(pos, 0, nperm - 1), sym, ln > 0)
            return nxt + hit.astype(I)

        lax.fori_loop(0, nsym, place, bidx)
        sync()
        return jnp.max(incl, axis=1) > (1 << 15)

    # ---- block header, precode lengths, code-length RLE
    def header(s, step):
        s = refill(s)
        mode, final, idx = s["mode"], s["final"], s["idx"]
        nlit, ndist, hclen = s["nlit"], s["ndist"], s["hclen"]
        prev, rep, repval = s["prev"], s["rep"], s["repval"]
        active = mode < DONE
        mS = mode == BLKSTART
        b3 = (s["lo"] & U(7)).astype(I)
        newfin = jnp.where(mS, b3 & 1, final)
        btype = b3 >> 1
        s = consume(s, jnp.where(mS, 3, 0))
        bad = mS & (btype == 3)

        mSt = mS & (btype == 0)                      # stored
        s = consume(s, jnp.where(mSt, (8 - (s["bitpos"] & 7)) & 7, 0))
        s = refill(s)
        slen = (s["lo"] & U(0xFFFF)).astype(I)
        snlen = (s["lo"] >> U(16)).astype(I) & 0xFFFF
        bad = bad | (mSt & (slen != (snlen ^ 0xFFFF)))
        s = consume(s, jnp.where(mSt, 32, 0))
        srem = jnp.where(mSt, slen, s["srem"])

        mStat = mS & (btype == 1)                    # static
        mDyn = mS & (btype == 2)                     # dynamic
        tb = jnp.where(mStat, srow, jnp.where(mDyn, row, s["tb"]))
        hl = (s["lo"] & U(31)).astype(I)
        s = consume(s, jnp.where(mDyn, 5, 0))
        hd = (s["lo"] & U(31)).astype(I)
        s = consume(s, jnp.where(mDyn, 5, 0))
        hc = (s["lo"] & U(15)).astype(I)
        s = consume(s, jnp.where(mDyn, 4, 0))
        nlit = jnp.where(mDyn, 257 + hl, nlit)
        ndist = jnp.where(mDyn, 1 + hd, ndist)
        hclen = jnp.where(mDyn, 4 + hc, hclen)
        bad = bad | (mDyn & ((nlit > 286) | (ndist > 30)))
        idx = jnp.where(mDyn, 0, idx)
        prev = jnp.where(mDyn, -1, prev)
        rep = jnp.where(mDyn, 0, rep)

        after = jnp.where(newfin == 1, DONE, BLKSTART)
        mode = jnp.where(mSt, jnp.where(slen > 0, STORED, after), mode)
        mode = jnp.where(mStat, BODY, mode)
        mode = jnp.where(mDyn, PRELEN, mode)
        # a final stored block of length 0 ends the stream here
        donestep = jnp.where(mSt & (slen == 0) & (newfin == 1), step,
                             s["donestep"])

        # PRELEN: one 3-bit precode length per step
        mP = active & (mode == PRELEN) & ~mS
        sym_at = tab[srow + T_ORDER + jnp.clip(idx, 0, 18)]
        put(row + T_PLENS + sym_at, (s["lo"] & U(7)).astype(I), mP)
        s = consume(s, jnp.where(mP, 3, 0))
        idx = jnp.where(mP, idx + 1, idx)
        mPd = mP & (idx >= hclen)
        pre_bad = lax.cond(
            _count(mPd) > 0,
            lambda: build(mPd, T_PLENS, 19,
                          lambda sym: tab[srow + T_INV_ORDER + sym] < hclen,
                          T_PRE_LIM, T_PRE_FB, T_PRE_PERM, 19),
            lambda: jnp.zeros((lanes,), bool))
        bad = bad | (mPd & pre_bad)
        mode = jnp.where(mPd, LENS, mode)
        idx = jnp.where(mPd, 0, idx)

        # LENS: code-length RLE, one length written per step
        s = refill(s)
        mL = active & (mode == LENS) & ~mS & ~mP
        drain = mL & (rep > 0)
        dec = mL & ~drain
        sym, clen, badc = decode(s["lo"], row, T_PRE_LIM, T_PRE_FB,
                                 T_PRE_PERM, 19)
        s = consume(s, jnp.where(dec, clen, 0))
        e16 = dec & (sym == 16)
        e17 = dec & (sym == 17)
        e18 = dec & (sym == 18)
        elit = dec & (sym <= 15)
        rbits = jnp.where(e16, 2, jnp.where(e17, 3, jnp.where(e18, 7, 0)))
        rv = bits(s["lo"], rbits)
        s = consume(s, jnp.where(dec, rbits, 0))
        newrep = jnp.where(e16 | e17, 3 + rv, jnp.where(e18, 11 + rv, 0))
        repval = jnp.where(e16, prev, jnp.where(e17 | e18, 0, repval))
        bad = bad | (dec & badc) | (e16 & (prev < 0))
        bad = bad | (dec & ~elit & (idx + newrep > nlit + ndist))
        wm = elit | drain
        dst = jnp.where(idx < nlit, idx, 288 + idx - nlit)
        put(row + T_LENS + jnp.clip(dst, 0, 319),
            jnp.where(elit, sym, repval), wm)
        idx = jnp.where(wm, idx + 1, idx)
        rep = jnp.where(drain, rep - 1, jnp.where(dec, newrep, rep))
        prev = jnp.where(elit, sym, prev)
        mode = jnp.where(mL & (idx >= nlit + ndist), AWAITBUILD, mode)
        mode = jnp.where(bad, BAD, mode)
        return dict(s, mode=mode, final=newfin, idx=idx, nlit=nlit,
                    ndist=ndist, hclen=hclen, prev=prev, rep=rep,
                    repval=repval, srem=srem, tb=tb, donestep=donestep)

    def build_tables(s):
        mW = s["mode"] == AWAITBUILD
        b1 = build(mW, T_LENS, 288, lambda sym: sym < s["nlit"],
                   T_LL_LIM, T_LL_FB, T_LL_PERM, 288)
        b2 = build(mW, T_LENS + 288, 32, lambda sym: sym < s["ndist"],
                   T_OF_LIM, T_OF_FB, T_OF_PERM, 32)
        return dict(s, mode=jnp.where(mW, jnp.where(b1 | b2, BAD, BODY),
                                      s["mode"]))

    # ---- block body: one literal, end of block or match per step
    def body(s, tokv, step):
        s = refill(s)
        mB = s["mode"] == BODY
        final, outpos = s["final"], s["outpos"]
        sym, clen, badc = decode(s["lo"], s["tb"], T_LL_LIM, T_LL_FB,
                                 T_LL_PERM, 288)
        is_lit = mB & (sym < 256)
        is_eob = mB & (sym == 256)
        is_len = mB & (sym > 256)
        eb, lbase = _len_extra(sym)
        length = lbase + bits(_shr(s["lo"], clen.astype(U)), eb)
        s = consume(s, jnp.where(mB, clen, 0) + jnp.where(is_len, eb, 0))
        bad = mB & (badc | (sym > 285))
        bad = bad | (is_lit & (outpos + 1 > out_cap))
        lit_ok = is_lit & ~bad
        tokv = jnp.where(lit_ok, (KIND_LIT << KIND_SHIFT) | sym, tokv)
        outpos = jnp.where(lit_ok, outpos + 1, outpos)
        mode = jnp.where(is_eob, jnp.where(final == 1, DONE, BLKSTART),
                         s["mode"])
        donestep = jnp.where(is_eob & (final == 1), step, s["donestep"])
        mode = jnp.where(bad, BAD, mode)
        mlen = is_len & ~bad
        s = dict(s, mode=mode, outpos=outpos, donestep=donestep)

        def dist(s, tokv):
            s = refill(s)
            outpos = s["outpos"]
            dsym, dlen, dbadc = decode(s["lo"], s["tb"], T_OF_LIM, T_OF_FB,
                                       T_OF_PERM, 32)
            deb, dbase = _dist_extra(dsym)
            d = dbase + bits(_shr(s["lo"], dlen.astype(U)), deb)
            s = consume(s, jnp.where(mlen, dlen + deb, 0))
            badd = mlen & (dbadc | (dsym > 29) | (d > outpos)
                           | (outpos + length > out_cap))
            ok = mlen & ~badd
            tokv = jnp.where(ok, (KIND_MATCH << KIND_SHIFT) | (length - 3)
                             | ((d - 1) << 8), tokv)
            return dict(s, outpos=jnp.where(ok, outpos + length, outpos),
                        mode=jnp.where(badd, BAD, s["mode"])), tokv

        return lax.cond(_count(mlen) > 0, dist, lambda s, t: (s, t),
                        s, tokv)

    def stored(s, tokv, step):
        s = refill(s)
        mV = s["mode"] == STORED
        byte = (s["lo"] & U(0xFF)).astype(I)
        s = consume(s, jnp.where(mV, 8, 0))
        bad = mV & (s["outpos"] + 1 > out_cap)
        ok = mV & ~bad
        tokv = jnp.where(ok, (KIND_LIT << KIND_SHIFT) | byte, tokv)
        srem = jnp.where(mV, s["srem"] - 1, s["srem"])
        end = mV & (srem == 0)
        mode = jnp.where(end, jnp.where(s["final"] == 1, DONE, BLKSTART),
                         s["mode"])
        return dict(s, outpos=jnp.where(ok, s["outpos"] + 1, s["outpos"]),
                    srem=srem, mode=jnp.where(bad, BAD, mode),
                    donestep=jnp.where(end & (s["final"] == 1), step,
                                       s["donestep"])), tokv

    # ---- step loop
    def step_fn(carry):
        step, s, _ = carry
        s = lax.cond(_count(s["mode"] <= LENS) > 0,
                     lambda s: header(s, step), lambda s: s, s)
        s = lax.cond(_count(s["mode"] == AWAITBUILD) > 0, build_tables,
                     lambda s: s, s)
        tokv = zeros()
        s, tokv = lax.cond(_count(s["mode"] == BODY) > 0,
                           lambda s, t: body(s, t, step),
                           lambda s, t: (s, t), s, tokv)
        s, tokv = lax.cond(_count(s["mode"] == STORED) > 0,
                           lambda s, t: stored(s, t, step),
                           lambda s, t: (s, t), s, tokv)
        # consumed past the end of the input: malformed
        over = (s["mode"] < DONE) & (s["bitpos"] > inbits)
        s = dict(s, mode=jnp.where(over, BAD, s["mode"]))
        tok_ref[step, pl.ds(base, lanes)] = tokv
        return step + 1, s, _count(s["mode"] < DONE)

    s0 = {k: zeros() for k in (
        "final", "outpos", "srem", "nlit", "ndist", "hclen", "idx", "rep",
        "repval", "nbits", "bitpos", "tb")}
    s0.update(mode=jnp.where(inbits > 0, BLKSTART, BAD), prev=zeros() - 1,
              donestep=zeros() - 1, lo=jnp.zeros((lanes,), U),
              hi=jnp.zeros((lanes,), U))
    laststep, s, _ = lax.while_loop(
        lambda c: (c[0] < max_steps) & (c[2] > 0), step_fn,
        (jnp.int32(0), s0, jnp.int32(1)))
    for r, v in ((S_MODE, s["mode"]), (S_OUTPOS, s["outpos"]),
                 (S_DONESTEP, s["donestep"]), (S_BITPOS, s["bitpos"]),
                 (S_LASTSTEP, zeros() + laststep)):
        stats_ref[r, pl.ds(base, lanes)] = v


# ============================== host wrapper ==============================
def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def layout(n: int, multiple: int = 1) -> tuple[int, int]:
    """(programs, lanes) for a batch of n streams over `multiple`
    devices. A program's step costs about the same whatever its lane
    count while the card has room for more programs, so streams are
    spread one per program up to MAX_PROGRAMS per device and packed
    more densely only beyond that (PERF.md has the sweep). Lanes and
    programs per device are powers of two, which bounds the compiled
    variants; a batch smaller than one program is padded to one."""
    per_device = -(-max(n, 1) // multiple)
    lanes = min(MAX_LANES, _next_pow2(-(-per_device // MAX_PROGRAMS)))
    return _next_pow2(-(-per_device // lanes)) * multiple, lanes


def pack_streams(streams: list[bytes], npad: int, in_cap: int = IN_CAP):
    """Kernel inputs: inbits (npad,) int32 bits per stream and words
    (npad, in_cap // 4 + 2) int32, one zero-padded stream per row (the
    two spare words cover the decoder's peek past the end). Streams
    that are empty or over in_cap are left out: ok[i] False."""
    in_words = in_cap // 4 + 2
    buf = np.zeros((npad, in_words * 4), np.uint8)
    inbits = np.zeros(npad, np.int32)
    ok = []
    for i, data in enumerate(streams):
        ok.append(0 < len(data) <= in_cap)
        if ok[-1]:
            buf[i, :len(data)] = np.frombuffer(data, np.uint8)
            inbits[i] = len(data) * 8
    return inbits, buf.view("<i4"), ok


@functools.lru_cache(maxsize=8)
def _jit_pass1(programs: int, lanes: int, max_steps: int,
               in_cap: int = IN_CAP, out_cap: int = OUT_CAP,
               interpret: bool = False):
    """jit: (inbits (npad,), words (npad, in_words)) -> (tok (max_steps,
    npad) int32, stats (NSTATS, npad) int32), npad = programs * lanes.
    Unwritten token rows stay 0 (NOP)."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the pass-1 decoder kernel needs a CUDA GPU (JAX backend "
            f"{jax.default_backend()!r}); tests pass interpret=True")
    npad = programs * lanes
    in_words = in_cap // 4 + 2

    def kernel(inbits_ref, words_ref, tab_in, tok_in, tab_ref, tok_ref,
               stats_ref):
        del tab_in, tok_in          # aliased to tab_ref, tok_ref
        _decode_lanes(inbits_ref, words_ref, tab_ref, tok_ref, stats_ref,
                     pl.program_id(0) * lanes, lanes, npad=npad,
                     in_words=in_words, max_steps=max_steps,
                     out_cap=out_cap, barrier=not interpret)

    call = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct(((npad + 1) * ROW,), jnp.int32),
                   jax.ShapeDtypeStruct((max_steps, npad), jnp.int32),
                   jax.ShapeDtypeStruct((NSTATS, npad), jnp.int32)),
        grid=(programs,),
        input_output_aliases={2: 0, 3: 1},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="inflate_pass1",
    )

    def run(inbits, words):
        tab = jnp.zeros(((npad + 1) * ROW,), jnp.int32)
        tab = tab.at[npad * ROW:].set(jnp.asarray(_STATIC_ROW))
        tok = jnp.zeros((max_steps, npad), jnp.int32)
        _, tok, stats = call(inbits, words.reshape(-1), tab, tok)
        return tok, stats

    return jax.jit(run)


def in_cap_bucket(streams) -> int:
    """Input-capacity bucket (compressed bytes per stream); each bucket
    compiles its own kernel variant."""
    need = max([len(x) for x in streams] or [1])
    for b in _IN_BUCKETS:
        if need <= b:
            return b
    return _IN_BUCKETS[-1]


# device memory guard: the token buffer costs max_steps * npad * 4
# bytes; decline the device path (host decode) rather than run out.
# A tenth of an H100's 80 GB leaves room for the device resolver.
_TOK_BYTES_MAX = 8 << 30


def _pass1(streams, max_steps, in_cap, out_cap, interpret):
    """-> (tok device array, stats host array, ok flags) or None when
    the token buffer would exceed _TOK_BYTES_MAX."""
    if in_cap is None:
        in_cap = in_cap_bucket(streams)
    programs, lanes = layout(len(streams))
    npad = programs * lanes
    if max_steps * npad * 4 > _TOK_BYTES_MAX:
        return None
    inbits, words, ok = pack_streams(streams, npad, in_cap)
    run = _jit_pass1(programs, lanes, max_steps, in_cap, out_cap,
                     interpret)
    tok, stats = run(jnp.asarray(inbits), jnp.asarray(words))
    return tok, np.asarray(stats), ok


def token_columns(tok, stats, ok, n: int, max_steps: int):
    """Fetch the written token rows and split them per stream ->
    list of (token column | None, expected output length)."""
    laststep = int(stats[S_LASTSTEP].max())
    nrows = min(max_steps, -(-max(laststep, 1) // 1024) * 1024)
    toks = np.asarray(tok[:nrows])
    out = []
    for i in range(n):
        if not ok[i] or stats[S_MODE, i] != DONE:
            out.append((None, 0))
            continue
        out.append((np.ascontiguousarray(toks[:, i]),
                    int(stats[S_OUTPOS, i])))
    return out


def decode_tokens_device(streams: list[bytes], max_steps: int = 72 * 1024,
                         in_cap: int | None = None,
                         out_cap: int = OUT_CAP, interpret: bool = False):
    """Pass 1 on the device: raw-DEFLATE streams -> per stream
    (token column int32 array | None, expected output length). Streams
    over the input cap or that the kernel flags yield None."""
    if not streams:
        return []
    r = _pass1(streams, max_steps, in_cap, out_cap, interpret)
    if r is None:
        return [(None, 0)] * len(streams)
    return token_columns(*r, len(streams), max_steps)


_STEP_BUCKETS = (1024, 2048, 4096, 16384, 72 * 1024, 288 * 1024,
                 1088 * 1024)
_IN_BUCKETS = (65536, 262144, 1048576)


def steps_for_caps(caps) -> int:
    """Step budget bucket for a batch (bucketed to bound compiled
    variants). A stream needs one step per token, at most one per output
    byte, plus its block headers: a dynamic header takes up to 19 + 316
    steps, which the 1024 slack covers for a few blocks per stream.
    Streams that exceed
    the budget end not-DONE and are decoded on the host."""
    need = max([c for c in caps] or [0]) + 1024
    for b in _STEP_BUCKETS:
        if need <= b:
            return b
    return _STEP_BUCKETS[-1]


def _resolve_one(job):
    from ...native.host import native_resolve_tokens

    col, outlen = job
    if col is None:
        return None
    got = native_resolve_tokens(col, outlen)
    if got is not None and len(got) != outlen:
        got = None
    return got


def inflate_device_tokens(streams: list[bytes], max_steps: int = 72 * 1024,
                          in_cap: int | None = None,
                          out_cap: int = OUT_CAP, interpret: bool = False):
    """Two-pass decode: pass 1 on the device, pass 2 with the C resolver
    fanned out on the host pool (it releases the GIL). Returns
    list[bytes | None]."""
    from ...parallel.hostpool import pmap

    return pmap(_resolve_one,
                decode_tokens_device(streams, max_steps, in_cap, out_cap,
                                     interpret))


_CAP_BUCKETS = (2048, 16384, 65536, 262144, 1048576)


def cap_bucket(caps) -> int:
    """Output-capacity bucket for the device resolver (bounds compiled
    variants the same way steps_for_caps bounds pass-1 variants)."""
    need = max([c for c in caps] or [1])
    for b in _CAP_BUCKETS:
        if need <= b:
            return b
    return _CAP_BUCKETS[-1]


def resolve_columns(n: int, npad: int) -> int:
    """Token columns the device resolver reads for n real streams of a
    layout of npad: n rounded up to an eighth of npad. This skips most
    of the padding and bounds the resolver's compiled variants to eight
    per layout."""
    step = max(1, npad // 8)
    return min(npad, -(-max(n, 1) // step) * step)


@functools.lru_cache(maxsize=16)
def _jit_resolve_tok(out_cap: int, ncols: int):
    """jit: pass-1 tokens (max_steps, npad) -> (bytes (ncols, out_cap)
    uint8, outlen (ncols,), ok (ncols,)) for the first ncols streams."""
    from ..resolve import resolve_batch_jax

    return jax.jit(lambda tok: resolve_batch_jax(tok[:, :ncols].T, out_cap))


def resolve_tokens_device(tok, n: int, out_cap: int):
    """Device copy resolution (ops/resolve.py) of the first n streams'
    pass-1 tokens; the outputs cover resolve_columns(n, npad) streams."""
    return _jit_resolve_tok(out_cap, resolve_columns(n, tok.shape[1]))(tok)


def fused_results(out, outlen, okr, stats, ok, n: int, out_cap: int):
    """Per-stream bytes | None from the device resolver's outputs."""
    out_h = np.asarray(out)
    len_h = np.asarray(outlen)
    okr_h = np.asarray(okr)
    res = []
    for i in range(n):
        explen = int(stats[S_OUTPOS, i])
        if (not ok[i] or stats[S_MODE, i] != DONE or not okr_h[i]
                or int(len_h[i]) != explen or explen > out_cap):
            res.append(None)
            continue
        res.append(out_h[i, :explen].tobytes())
    return res


def inflate_device_fused(streams: list[bytes], max_steps: int = 72 * 1024,
                         out_cap: int = OUT_CAP, in_cap: int | None = None,
                         interpret: bool = False):
    """Two-pass decode with both passes on the device: the pass-1 tokens
    feed the XLA copy-resolution pass (ops/resolve.py) without leaving
    device memory; only decoded bytes are fetched. Returns
    list[bytes | None]."""
    n = len(streams)
    if n == 0:
        return []
    r = _pass1(streams, max_steps, in_cap, out_cap, interpret)
    if r is None:
        return [None] * n
    tok, stats, ok = r
    out, outlen, okr = resolve_tokens_device(tok, n, out_cap)
    return fused_results(out, outlen, okr, stats, ok, n, out_cap)
