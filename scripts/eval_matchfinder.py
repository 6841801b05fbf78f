#!/usr/bin/env python3
"""Matchfinder design-lever evaluation for the device dynamic tier.

Runs find_matches variants through the REAL device pipeline stages
(extend_runs + select_tokens, jax on the CPU backend) and computes the
EXACT dynamic-block compressed size from token histograms (native
package-merge tables + per-symbol code/extra bits) — no emit needed.
This measures which levers close the ratio gap to libdeflate-6 (3.018
on the silesia-like corpus) before any device implementation work.

Levers (cumulative flags):
  cap16   carry 3 words in the sort -> exact lengths <= 16 (base: 8)
  k2      check 2 predecessors in sorted order, keep the longer match
  sort8   second sort keyed on 8 bytes: nearest occurrence sharing >= 8
  ext     oracle: extend every selected candidate to its true length
          (numpy while-loop; models a device extension pass)
  lazy    one-position lazy arbitration before selection
  mm3     (reported separately) minimum match 3 via 3-byte-key sort

Usage: JAX_PLATFORMS=cpu python scripts/eval_matchfinder.py [members...]
"""

from __future__ import annotations

import os
import sys
import time
import zlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), "..",
                                   ".jax_cache"))

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benches"))

import numpy as np

import jax
import jax.numpy as jnp

from libdeflate_rsx_tpu.common import MAX_MATCH_LEN, WINDOW_SIZE
from libdeflate_rsx_tpu.native import dyn_tables_native
from libdeflate_rsx_tpu.ops import encode_v2 as e2
from libdeflate_rsx_tpu.ops.encode_dynamic import NUM_LITLEN, NUM_OFFSET
from libdeflate_rsx_tpu.ops.static_codes import (
    length_sym_fields,
    offset_sym_fields,
)

U = jnp.uint32
BLOCK = 65536
MIN_MATCH = 4


def _words_at(data_padded: jnp.ndarray, off: int, s: int) -> jnp.ndarray:
    d = data_padded.astype(U)
    w = (d[off:off + s] | (d[off + 1:off + 1 + s] << U(8))
         | (d[off + 2:off + 2 + s] << U(16))
         | (d[off + 3:off + 3 + s] << U(24)))
    return w


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


def find_matches_var(data_padded, valid_len, s, *, nwords=1, k=1,
                     sort8=False):
    """Variant matchfinder: nearest-previous occurrences from sorted
    order with `k` predecessors, `nwords` carried words (exact length
    cap 4 + 4*nwords), optional second 8-byte-key sort."""
    w0 = _words_at(data_padded, 0, s)
    ws = [_words_at(data_padded, 4 * (j + 1), s) for j in range(nwords)]
    pos = jnp.arange(s, dtype=jnp.int32)

    ops = jax.lax.sort((w0, pos, *ws), dimension=0, num_keys=1,
                       is_stable=True)
    w0s, poss, wss = ops[0], ops[1], ops[2:]

    def shift(a, j):
        return jnp.concatenate([a[:j] * 0, a[:-j]])

    best_ml = jnp.zeros(s, jnp.int32)
    best_dist = jnp.zeros(s, jnp.int32)

    def merge(ml_new, dist_new, best_ml, best_dist):
        better = (ml_new > best_ml) | ((ml_new == best_ml)
                                       & (dist_new < best_dist)
                                       & (ml_new > 0))
        return (jnp.where(better, ml_new, best_ml),
                jnp.where(better, dist_new, best_dist))

    for j in range(1, k + 1):
        same = shift(w0s, j) == w0s
        same = same & (shift(pos, j) >= j)      # guard padding rows
        cand = shift(poss, j)
        dist = poss - cand
        ok = same & (dist >= 1) & (dist <= WINDOW_SIZE)
        xs = [wss[i] ^ shift(wss[i], j) for i in range(nwords)]
        ml = 4 + _ml_from_xors(xs)
        ml = jnp.where(ok, ml, 0)
        dist = jnp.where(ok, dist, 0)
        b_ml, b_dist = merge(ml, dist, jnp.zeros(s, jnp.int32),
                             jnp.zeros(s, jnp.int32))
        # un-sort this candidate back to position order
        packed = b_dist.astype(U) | (b_ml.astype(U) << U(20))
        _, packed_u = jax.lax.sort((poss, packed), dimension=0, num_keys=1)
        ml_u = (packed_u >> U(20)).astype(jnp.int32)
        dist_u = (packed_u & U(0xFFFFF)).astype(jnp.int32)
        best_ml, best_dist = merge(ml_u, dist_u, best_ml, best_dist)

    if sort8:
        w1 = _words_at(data_padded, 4, s)
        n8 = min(2, nwords)  # carried words for the 8-byte sort
        ws8 = [_words_at(data_padded, 8 + 4 * i, s) for i in range(n8)]
        ops = jax.lax.sort((w0, w1, pos, *ws8), dimension=0, num_keys=2,
                           is_stable=True)
        w0s8, w1s8, poss8, wss8 = ops[0], ops[1], ops[2], ops[3:]
        same = (shift(w0s8, 1) == w0s8) & (shift(w1s8, 1) == w1s8)
        same = same & (shift(pos, 1) >= 1)
        cand = shift(poss8, 1)
        dist = poss8 - cand
        ok = same & (dist >= 1) & (dist <= WINDOW_SIZE)
        xs = [wss8[i] ^ shift(wss8[i], 1) for i in range(n8)]
        ml = 8 + _ml_from_xors(xs)
        ml = jnp.where(ok, ml, 0)
        dist = jnp.where(ok, dist, 0)
        packed = dist.astype(U) | (ml.astype(U) << U(20))
        _, packed_u = jax.lax.sort((poss8, packed), dimension=0, num_keys=1)
        ml_u = (packed_u >> U(20)).astype(jnp.int32)
        dist_u = (packed_u & U(0xFFFFF)).astype(jnp.int32)
        best_ml, best_dist = merge(ml_u, dist_u, best_ml, best_dist)

    cap = jnp.clip(valid_len - pos, 0, 4 + 4 * nwords if not sort8
                   else max(4 + 4 * nwords, 8 + 4 * n8))
    best_ml = jnp.minimum(best_ml, jnp.clip(valid_len - pos, 0, 258))
    best_ml = jnp.where(best_ml >= MIN_MATCH, best_ml, 0)
    return best_ml, best_dist


def find_matches_ladder(data_padded, valid_len, s, *, nwords=3, k=2,
                        max_tier=256, kt=1):
    """Prefix-doubling candidate ladder (suffix-array flavored): tier L
    finds the nearest previous occurrence sharing >= L bytes, via dense
    ranks of L/2-byte prefixes sorted as (rank[i], rank[i+L/2]) pairs.
    Tiers L = 8..max_tier each cost one 2-key sort + scans. Candidates
    merge with the base k-predecessor sort4 tier by (longer, nearer).
    Lengths from upper tiers are EXACT-at-least-L; the oracle extension
    (or a device extension pass) resolves true lengths."""
    pos = jnp.arange(s, dtype=jnp.int32)

    def shift(a, j):
        return jnp.concatenate([a[:j] * 0, a[:-j]])

    def merge(ml_new, dist_new, best_ml, best_dist):
        better = (ml_new > best_ml) | ((ml_new == best_ml)
                                       & (dist_new < best_dist)
                                       & (ml_new > 0))
        return (jnp.where(better, ml_new, best_ml),
                jnp.where(better, dist_new, best_dist))

    best_ml, best_dist = find_matches_var(
        data_padded, valid_len, s, nwords=nwords, k=k, sort8=False)

    # dense rank of the 4-byte prefix
    w0 = _words_at(data_padded, 0, s)
    w0s, poss = jax.lax.sort((w0, pos), dimension=0, num_keys=1,
                             is_stable=True)
    newg = jnp.concatenate([jnp.ones(1, jnp.int32),
                            (w0s[1:] != w0s[:-1]).astype(jnp.int32)])
    rk_s = jnp.cumsum(newg)
    _, rank = jax.lax.sort((poss, rk_s), dimension=0, num_keys=1)

    half = 4
    while half * 2 <= max_tier:
        L = half * 2
        rb = jnp.where(pos + half < s,
                       jnp.concatenate([rank[half:], jnp.zeros(half,
                                                               rank.dtype)]),
                       0)
        ra_s, rb_s, poss = jax.lax.sort((rank, rb, pos), dimension=0,
                                        num_keys=2, is_stable=True)
        for j in range(1, kt + 1):
            same = (shift(ra_s, j) == ra_s) & (shift(rb_s, j) == rb_s) \
                & (shift(pos, j) >= j) & (rb_s > 0)
            cand = shift(poss, j)
            dist = poss - cand
            ok = same & (dist >= 1) & (dist <= WINDOW_SIZE)
            ml = jnp.where(ok, L, 0)
            dd = jnp.where(ok, dist, 0)
            packed = dd.astype(U) | (ml.astype(U) << U(20))
            _, packed_u = jax.lax.sort((poss, packed), dimension=0,
                                       num_keys=1)
            ml_u = (packed_u >> U(20)).astype(jnp.int32)
            dist_u = (packed_u & U(0xFFFFF)).astype(jnp.int32)
            best_ml, best_dist = merge(ml_u, dist_u, best_ml, best_dist)
        # ranks for the next level from this sorted order
        newg = jnp.concatenate([jnp.ones(1, jnp.int32),
                                ((ra_s[1:] != ra_s[:-1])
                                 | (rb_s[1:] != rb_s[:-1])).astype(
                                     jnp.int32)])
        rk_s = jnp.cumsum(newg)
        _, rank = jax.lax.sort((poss, rk_s), dimension=0, num_keys=1)
        half = L

    best_ml = jnp.minimum(best_ml, jnp.clip(valid_len - pos, 0, 258))
    best_ml = jnp.where(best_ml >= MIN_MATCH, best_ml, 0)
    return best_ml, best_dist


def find_matches_direct(data_padded, valid_len, s, *, k=2,
                        tiers=(8, 16), tier_k=2, carry=2):
    """Direct multi-word-key tier ladder (no ranks, no cumsum — both
    measured expensive where first evaluated): tier L sorts by the raw L-byte prefix
    (L/4 u32 keys); adjacent rows with equal keys share >= L bytes and,
    by stable position order, the j-th predecessor is the j-th nearest.
    Carried next-words give exact lengths to L + 4*carry. All tiers
    merge by (longer, nearer); extend_runs composes beyond the caps."""
    pos = jnp.arange(s, dtype=jnp.int32)

    def shift(a, j):
        return jnp.concatenate([a[:j] * 0, a[:-j]])

    def merge(ml_new, dist_new, best_ml, best_dist):
        better = (ml_new > best_ml) | ((ml_new == best_ml)
                                       & (dist_new < best_dist)
                                       & (ml_new > 0))
        return (jnp.where(better, ml_new, best_ml),
                jnp.where(better, dist_new, best_dist))

    best_ml, best_dist = find_matches_var(
        data_padded, valid_len, s, nwords=3, k=k, sort8=False)

    for L in tiers:
        nk = L // 4
        keys = [_words_at(data_padded, 4 * i, s) for i in range(nk)]
        carries = [_words_at(data_padded, L + 4 * i, s)
                   for i in range(carry)]
        ops = jax.lax.sort((*keys, pos, *carries), dimension=0,
                           num_keys=nk, is_stable=True)
        keys_s = ops[:nk]
        poss = ops[nk]
        car_s = ops[nk + 1:]
        acc_ml = jnp.zeros(s, jnp.int32)
        acc_d = jnp.zeros(s, jnp.int32)
        for j in range(1, tier_k + 1):
            same = jnp.ones(s, bool)
            for kk in keys_s:
                same = same & (shift(kk, j) == kk)
            same = same & (shift(pos, j) >= j)
            cand = shift(poss, j)
            dist = poss - cand
            ok = same & (dist >= 1) & (dist <= WINDOW_SIZE)
            xs = [c ^ shift(c, j) for c in car_s]
            ml = L + _ml_from_xors(xs)
            ml = jnp.where(ok, ml, 0)
            dist = jnp.where(ok, dist, 0)
            acc_ml, acc_d = merge(ml, dist, acc_ml, acc_d)
        packed = acc_d.astype(U) | (acc_ml.astype(U) << U(20))
        _, packed_u = jax.lax.sort((poss, packed), dimension=0, num_keys=1)
        ml_u = (packed_u >> U(20)).astype(jnp.int32)
        dist_u = (packed_u & U(0xFFFFF)).astype(jnp.int32)
        best_ml, best_dist = merge(ml_u, dist_u, best_ml, best_dist)

    best_ml = jnp.minimum(best_ml, jnp.clip(valid_len - pos, 0, 258))
    best_ml = jnp.where(best_ml >= MIN_MATCH, best_ml, 0)
    return best_ml, best_dist


def find_matches_strided(data_padded, valid_len, s, *, k=2,
                         tiers=((16, 2), (64, 8)), tier_k=2, carry=2,
                         decay=True):
    """Strided exact tier ladder: tier (L, stride) sorts only positions
    on the stride grid (sort elements / stride) with the raw L-byte
    prefix as keys — a match of length >= L + stride - 1 always has a
    grid point inside it, so long matches survive sampling. A covering
    decay scan (prefix max of ml[q] + q, distance packed in the low
    bits) then spreads each long candidate to the positions it covers,
    restoring full-resolution entry points for selection and making
    same-distance chains contiguous for extend_runs."""
    pos = jnp.arange(s, dtype=jnp.int32)

    def shift(a, j):
        return jnp.concatenate([a[:j] * 0, a[:-j]])

    def merge(ml_new, dist_new, best_ml, best_dist):
        better = (ml_new > best_ml) | ((ml_new == best_ml)
                                       & (dist_new < best_dist)
                                       & (ml_new > 0))
        return (jnp.where(better, ml_new, best_ml),
                jnp.where(better, dist_new, best_dist))

    best_ml, best_dist = find_matches_var(
        data_padded, valid_len, s, nwords=3, k=k, sort8=False)

    for L, stride in tiers:
        nk = L // 4
        m = s // stride
        gpos = jnp.arange(m, dtype=jnp.int32) * stride
        keys = [_words_at(data_padded, 4 * i, s)[::stride]
                for i in range(nk)]
        carries = [_words_at(data_padded, L + 4 * i, s)[::stride]
                   for i in range(carry)]
        ops = jax.lax.sort((*keys, gpos, *carries), dimension=0,
                           num_keys=nk, is_stable=True)
        keys_s = ops[:nk]
        poss = ops[nk]
        car_s = ops[nk + 1:]
        gidx = jnp.arange(m, dtype=jnp.int32)
        acc_ml = jnp.zeros(m, jnp.int32)
        acc_d = jnp.zeros(m, jnp.int32)
        for j in range(1, tier_k + 1):
            same = jnp.ones(m, bool)
            for kk in keys_s:
                same = same & (jnp.concatenate([kk[:j] * 0, kk[:-j]]) == kk)
            same = same & (jnp.concatenate(
                [jnp.full(j, -1, jnp.int32), gidx[:-j]]) >= 0)
            cand = jnp.concatenate([poss[:j] * 0, poss[:-j]])
            dist = poss - cand
            ok = same & (dist >= 1) & (dist <= WINDOW_SIZE)
            xs = [c ^ jnp.concatenate([c[:j] * 0, c[:-j]]) for c in car_s]
            ml = L + _ml_from_xors(xs)
            ml = jnp.where(ok, ml, 0)
            dist = jnp.where(ok, dist, 0)
            acc_ml, acc_d = merge(ml, dist, acc_ml, acc_d)
        packed = acc_d.astype(U) | (acc_ml.astype(U) << U(20))
        _, packed_u = jax.lax.sort((poss, packed), dimension=0, num_keys=1)
        ml_g = (packed_u >> U(20)).astype(jnp.int32)
        dist_g = (packed_u & U(0xFFFFF)).astype(jnp.int32)
        # scatter-free spread back to full resolution: strided arrays
        # placed on the grid via reshape (positions off-grid get 0)
        ml_f = jnp.zeros((m, stride), jnp.int32).at[:, 0].set(
            ml_g).reshape(s) if stride > 1 else ml_g
        dist_f = jnp.zeros((m, stride), jnp.int32).at[:, 0].set(
            dist_g).reshape(s) if stride > 1 else dist_g
        best_ml, best_dist = merge(ml_f, dist_f, best_ml, best_dist)

    if decay:
        # covering decay: every position learns the best match covering
        # it (value = end position ml[q]+q, distance in the low 15 bits;
        # ties prefer nearer). One doubling max-scan, no sorts/gathers.
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


def _two_level_u32max(x: jnp.ndarray) -> jnp.ndarray:
    n = x.shape[0]
    d = 1
    while d < n:
        x = jnp.maximum(x, jnp.concatenate(
            [jnp.zeros(d, x.dtype), x[:-d]]))
        d *= 2
    return x


def serial_select(ml, dist, valid, lazy=False, min_match=4,
                  too_far3=4096):
    """Oracle selection: the host's serial greedy (optionally lazy) walk
    with NO tile truncation — upper-bounds what a better parallel
    selection could reach with the same candidates."""
    n = len(ml)
    sel = np.zeros(n, bool)
    lit = np.zeros(n, bool)
    ml = ml.copy()
    p = 0
    while p < valid:
        l = int(ml[p])
        if l == 3 and dist[p] > too_far3:
            l = 0
        if l >= min_match:
            if lazy and p + 1 < valid:
                l2 = int(ml[p + 1])
                if l2 > l:
                    lit[p] = True
                    p += 1
                    continue
            sel[p] = True
            p += l
        else:
            lit[p] = True
            p += 1
    return ml, sel, lit


def add_sort3(data_padded, s, best_ml, best_dist, max_dist=4096):
    """3-byte-key tier: nearest previous occurrence sharing >= 3 bytes
    (DEFLATE's true minimum match; zlib emits len-3 only below a
    distance bound). Fills positions that have no 4-byte match."""
    d = data_padded.astype(U)
    w3 = d[:s] | (d[1:s + 1] << U(8)) | (d[2:s + 2] << U(16))
    pos = jnp.arange(s, dtype=jnp.int32)
    w3s, poss = jax.lax.sort((w3, pos), dimension=0, num_keys=1,
                             is_stable=True)
    same = jnp.concatenate([jnp.zeros(1, bool), w3s[1:] == w3s[:-1]])
    cand = jnp.concatenate([poss[:1] * 0, poss[:-1]])
    dist = poss - cand
    ok = same & (dist >= 1) & (dist <= max_dist)
    ml = jnp.where(ok, 3, 0)
    dist = jnp.where(ok, dist, 0)
    packed = dist.astype(U) | (ml.astype(U) << U(20))
    _, packed_u = jax.lax.sort((poss, packed), dimension=0, num_keys=1)
    ml_u = (packed_u >> U(20)).astype(jnp.int32)
    dist_u = (packed_u & U(0xFFFFF)).astype(jnp.int32)
    use = (best_ml == 0) & (ml_u == 3)
    return (jnp.where(use, ml_u, best_ml),
            jnp.where(use, dist_u, best_dist))


def oracle_extend(data: np.ndarray, ml: np.ndarray, dist: np.ndarray,
                  valid: int) -> np.ndarray:
    """True match lengths vs the chosen candidate (numpy oracle for a
    device extension pass). Extends every matched position to its real
    length, capped at 258 and the block end."""
    n = len(ml)
    pos = np.arange(n)
    ml = ml.copy()
    active = ml >= MIN_MATCH
    idx = np.where(active)[0]
    cur = ml[idx].astype(np.int64)
    d = dist[idx].astype(np.int64)
    p = idx.astype(np.int64)
    limit = np.minimum(258, valid - p)
    alive = cur < limit
    while alive.any():
        a = np.where(alive)[0]
        nxt = p[a] + cur[a]
        ok = data[nxt] == data[nxt - d[a]]
        cur[a[ok]] += 1
        hit = np.zeros(len(a), bool)
        hit[ok] = True
        alive[a[~ok]] = False
        alive = alive & (cur < limit)
    ml[idx] = cur.astype(ml.dtype)
    return ml


def block_cost_bits(byte, ml, dist, sel, lit, final) -> int:
    """Exact dynamic-block size in bits from the token stream."""
    lsym_t, lev, leb = length_sym_fields(jnp.asarray(
        np.maximum(ml, MIN_MATCH)))
    dsym_t, dev, deb = offset_sym_fields(jnp.asarray(
        np.clip(dist, 1, WINDOW_SIZE)))
    lsym = np.asarray(lsym_t)
    dsym = np.asarray(dsym_t)
    leb_n = np.asarray(leb).astype(np.int64)
    deb_n = np.asarray(deb).astype(np.int64)

    llh = np.zeros(NUM_LITLEN, np.uint32)
    np.add.at(llh, np.where(sel, lsym, byte)[sel | lit], 1)
    ofh = np.zeros(NUM_OFFSET, np.uint32)
    np.add.at(ofh, dsym[sel], 1)
    res = dyn_tables_native(llh, ofh, final)
    ll_tab, of_tab, hdr, hdr_bits = res
    ll_len = (ll_tab >> 16).astype(np.int64)
    of_len = (of_tab >> 16).astype(np.int64)
    bits = int(hdr_bits)
    bits += int(ll_len[byte[lit]].sum())
    bits += int((ll_len[lsym[sel]] + leb_n[sel]).sum())
    bits += int((of_len[dsym[sel]] + deb_n[sel]).sum())
    bits += int(ll_len[256])                     # EOB
    if not final:
        bits += (-bits) % 8 + 40                 # SYNC join (bit est.)
    return bits


def eval_member(data: bytes, variant: dict, block: int = BLOCK,
                lazy: bool = False, ext: bool = False,
                mm3: bool = False, sel_mode: str = "device",
                hist: bool = False) -> int:
    n = len(data)
    num = max(1, -(-n // block))
    total_bits = 0
    hlen = WINDOW_SIZE if hist else 0
    s = block + hlen
    fm = jax.jit(lambda d, v: find_matches_var(
        d, v, s, **variant), static_argnums=())
    er = jax.jit(lambda ml, dist, v: e2.extend_runs(ml, dist, v))
    st = jax.jit(lambda ml, dist, v: e2.select_tokens(ml, dist, v))
    s3 = jax.jit(lambda d, bm, bd: add_sort3(d, s, bm, bd))
    flat = np.frombuffer(data, np.uint8)
    for i in range(num):
        lo = i * block
        hi = min(lo + block, n)
        h = min(hlen, lo)
        arr = np.zeros(s + e2.BLOCK_PAD, np.uint8)
        arr[hlen - h: hlen + hi - lo] = flat[lo - h:hi]
        valid = hlen + hi - lo
        ml, dist = fm(jnp.asarray(arr), jnp.int32(valid))
        ml = er(ml, dist, jnp.int32(valid))
        if ext:
            ml_n = oracle_extend(arr, np.asarray(ml), np.asarray(dist),
                                 valid)
            ml = jnp.asarray(ml_n)
        if mm3:
            ml, dist = s3(jnp.asarray(arr), ml, dist)
        if hist:
            # history region emits nothing: selection starts fresh at
            # the payload boundary (the previous block ended there)
            posv = jnp.arange(s, dtype=jnp.int32)
            ml = jnp.where(posv >= hlen, ml, 0)
        if lazy and sel_mode == "device":
            # one-position lazy: a match is demoted if the next position
            # has a strictly longer one (host greedy's lazy rule)
            nxt = jnp.concatenate([ml[1:], jnp.zeros(1, jnp.int32)])
            keep = ~((nxt > ml) & (ml >= MIN_MATCH)
                     & (nxt >= MIN_MATCH))
            ml = jnp.where(keep, ml, 0)
        if sel_mode == "device":
            ml2, sel, lit = st(ml, dist, jnp.int32(valid))
            ml2, sel, lit = (np.asarray(ml2), np.asarray(sel),
                             np.asarray(lit))
        else:
            ml2, sel, lit = serial_select(
                np.asarray(ml), np.asarray(dist), valid, lazy=lazy,
                min_match=3 if mm3 else 4)
        if hist:
            sel = sel.copy()
            lit = lit.copy()
            sel[:hlen] = False
            lit[:hlen] = False
        total_bits += block_cost_bits(
            arr[:s].astype(np.int64), ml2,
            np.asarray(dist), sel, lit,
            i == num - 1)
    return (total_bits + 7) // 8


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    import gen_silesia_like
    import libdeflate_control as ldc
    d = os.path.join(os.path.dirname(__file__), "..", "benches", "corpus")
    if not os.path.isdir(d):
        gen_silesia_like.generate(d)
    members = sys.argv[1:] or ["dickens", "mozilla", "nci", "sao",
                               "webster", "xml"]
    best = dict(nwords=3, k=2, sort8=True)
    variants = [
        ("hist devsel lazy", best, dict(ext=True, lazy=True, hist=True)),
        ("hist serial lazy", best,
         dict(ext=True, lazy=True, sel_mode="serial", hist=True)),
        ("hist devsel lazy noext", best, dict(lazy=True, hist=True)),
    ]
    for m in members:
        data = open(os.path.join(d, m), "rb").read()
        ld6 = len(ldc.compress(data, 6))
        z6 = len(zlib.compress(data, 6))
        print(f"== {m} n={len(data)} ld6={len(data)/ld6:.3f} "
              f"zlib6={len(data)/z6:.3f}")
        for name, var, kw in variants:
            t0 = time.time()
            size = eval_member(data, var, **kw)
            print(f"  {name:24s} ratio={len(data)/size:.3f} "
                  f"({size} B, {time.time()-t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
