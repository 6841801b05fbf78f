/* Native host DEFLATE codec: encoder (levels 1-9), decoder, CRC-32,
 * Adler-32. The host-tier speed path of the framework — the analog of the
 * reference's Rust core (reference src/compress/mod.rs,
 * src/decompress/mod.rs), written fresh in C against RFC 1951:
 *
 *  - encoder: hash-chain matchfinder (hash4 multiplicative), greedy
 *    (levels 1-4) / lazy (levels 5-9) parse with per-level depth and
 *    nice-length knobs, per-block stored/static/dynamic selection by
 *    exact bit cost, optimal length-limited Huffman via package-merge,
 *    precode RLE dynamic headers, 64-bit LSB-first bit buffer.
 *  - decoder: flat 2^maxlen LSB-indexed decode tables (entry =
 *    (sym << 4) | len, the same layout as the Python engine), 64-bit
 *    refill, one-shot whole-buffer decode.
 *  - checksums: slice-by-8 CRC-32, unrolled Adler-32.
 *
 * Python keeps the resumable/streaming engine; this file serves the
 * one-shot hot paths via ctypes (see native/__init__.py).
 */

#if (defined(__x86_64__) || defined(__i386__)) && defined(__SSSE3__)
#include <immintrin.h>
#endif
#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* constants                                                           */
/* ------------------------------------------------------------------ */

#define MIN_MATCH 3
#define MAX_MATCH 258
#define WINDOW 32768
#define NUM_LITLEN 288
#define NUM_OFFSET 32
#define NUM_PRECODE 19
/* litlen codes are capped at 14 bits (the reference does the same,
 * reference src/compress/mod.rs:127-129): with a byte-aligned buffer
 * (<=7 bits pending) four fused literal writes are 7+4*14 = 63 <= 64
 * bits, enabling the unconditional 8-byte-store emit loop */
#define MAX_LL_LEN 14
#define MAX_OF_LEN 15
#define MAX_PRE_LEN 7
#define SOFT_BLOCK 300000
#define HASH_BITS 15
/* link-array ring: the LZ window (32 KiB) is smaller than the ring, so
 * live positions never collide; stale entries fail the window check */
#define MF_RING 65536
#define MF_RM (MF_RING - 1)
#define HASH_SIZE (1 << HASH_BITS)

#define ERR_BADDATA (-1)
#define ERR_SPACE (-2)
#define ERR_SHORT (-3)

static const uint16_t LEN_BASE[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t LEN_EXTRA[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t OFF_BASE[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
    8193, 12289, 16385, 24577};
static const uint8_t OFF_EXTRA[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
static const uint8_t PRE_PERM[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

/* length -> symbol index 0..28 */
static uint8_t LEN2SYM[MAX_MATCH + 1];
/* small-offset -> symbol for offsets 1..256 */
static uint8_t OFF2SYM_SMALL[257];
static uint8_t REV8[256]; /* byte bit-reversal LUT (canonical codes) */
#if defined(__SSSE3__)
/* k % off shuffle masks for the short-offset LZ pattern broadcast */
static __attribute__((aligned(16))) uint8_t PAT_MASK16[16][16];
#endif
static int tables_ready = 0;

static void init_tables(void) {
    if (tables_ready) return;
    for (int b = 0; b < 256; b++) {
        int r = 0;
        for (int k = 0; k < 8; k++) r |= ((b >> k) & 1) << (7 - k);
        REV8[b] = (uint8_t)r;
    }
#if defined(__SSSE3__)
    for (int off = 1; off < 16; off++)
        for (int k = 0; k < 16; k++)
            PAT_MASK16[off][k] = (uint8_t)(k % off);
#endif
    for (int s = 0; s < 29; s++) {
        int hi = (s == 28) ? 258 : LEN_BASE[s + 1] - 1;
        for (int l = LEN_BASE[s]; l <= hi && l <= MAX_MATCH; l++)
            LEN2SYM[l] = (uint8_t)s;
    }
    LEN2SYM[258] = 28;
    for (int s = 0; s < 30; s++) {
        int hi = (s == 29) ? 32768 : OFF_BASE[s + 1] - 1;
        for (int o = OFF_BASE[s]; o <= hi && o <= 256; o++)
            OFF2SYM_SMALL[o] = (uint8_t)s;
    }
    tables_ready = 1;
}

static inline int off2sym(uint32_t off) {
    if (off <= 256) return OFF2SYM_SMALL[off];
    /* offsets 257..32768 closed-form: symbol ranges double per pair,
     * so with k = bsr(off-1) the symbol is 2k plus the bit below the
     * top one (RFC 1951 offset code structure) */
    uint32_t o1 = off - 1;
    int k = 31 - __builtin_clz(o1);
    return 2 * k + (int)((o1 >> (k - 1)) & 1);
}

/* ------------------------------------------------------------------ */
/* bit writer (LSB-first)                                              */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *out, *end, *start;
    uint64_t buf;
    int n; /* bits in buf */
    int overflow;
    int error; /* sticky internal error (e.g. Huffman build failure) */
} BitW;

static inline void bw_init(BitW *w, uint8_t *out, int64_t cap) {
    w->out = out; w->start = out; w->end = out + cap;
    w->buf = 0; w->n = 0; w->overflow = 0; w->error = 0;
}

static inline void bw_flushbytes(BitW *w) {
    while (w->n >= 8) {
        if (w->out >= w->end) { w->overflow = 1; return; }
        *w->out++ = (uint8_t)w->buf;
        w->buf >>= 8; w->n -= 8;
    }
}

static inline void bw_put(BitW *w, uint32_t v, int bits) {
    /* flush BEFORE writing: v << n must not run off the 64-bit buffer
     * (single puts are <= 16 bits, so n <= 48 guarantees room) */
    if (w->n > 48) bw_flushbytes(w);
    w->buf |= (uint64_t)v << w->n;
    w->n += bits;
}

static inline void bw_align(BitW *w) {
    int pad = (8 - (w->n & 7)) & 7;
    if (pad) bw_put(w, 0, pad);
    bw_flushbytes(w);
}

static inline int64_t bw_finish(BitW *w) {
    bw_align(w);
    if (w->error) return w->error;
    if (w->overflow) return ERR_SPACE;
    return w->out - w->start;
}

/* bit-exact finish for FlushMode::None-style calls (reference
 * src/compress/mod.rs:424-429: compress keeps the bit buffer across
 * calls): no padding; the trailing partial byte is stored (the caller
 * carries its 0..7 valid bits) and the return value is the TOTAL BIT
 * length of the stream. */
static inline int64_t bw_finish_bits(BitW *w) {
    bw_flushbytes(w);
    if (w->error) return w->error;
    if (w->n && w->out >= w->end) w->overflow = 1;
    if (w->overflow) return ERR_SPACE;
    int64_t bits = (int64_t)(w->out - w->start) * 8 + w->n;
    if (w->n) *w->out = (uint8_t)w->buf;  /* partial byte, not counted */
    return bits;
}

/* ------------------------------------------------------------------ */
/* package-merge length-limited Huffman                                */
/* ------------------------------------------------------------------ */


/* lens[] out; returns 0 ok */
static int pm_lengths(const uint64_t *freq, int n, int limit, uint8_t *lens) {
    /* Flat-array package-merge: per level l, list[l] = merge(leaves,
     * pairwise packages of list[l-1]), entries packed (weight<<1 |
     * is_package) so one u64 compare both orders and breaks ties
     * leaves-first. Code lengths come from a downward prefix count:
     * taking the first `take` items of a level takes some prefix of
     * the (sorted) leaves plus p packages, each expanding to two items
     * one level down — lens[order[i]] = #levels whose leaf-prefix
     * exceeds i. O(u*L), no node pool, no tree walk. */
    int order[NUM_LITLEN];
    int used = 0;
    memset(lens, 0, (size_t)n);
    for (int i = 0; i < n; i++) if (freq[i]) order[used++] = i;
    if (used == 0) return 0;
    if (used == 1) { lens[order[0]] = 1; return 0; }
    if (limit > 15 || used > (1 << limit)) return -1;
    /* sort used symbols by freq: packed-key bottom-up merge sort */
    static __thread uint64_t keys[NUM_LITLEN], tmp[NUM_LITLEN];
    for (int i = 0; i < used; i++)
        keys[i] = (freq[order[i]] << 16) | (uint64_t)order[i];
    for (int width = 1; width < used; width <<= 1) {
        for (int lo = 0; lo < used; lo += 2 * width) {
            int mid = lo + width < used ? lo + width : used;
            int hi = lo + 2 * width < used ? lo + 2 * width : used;
            int a = lo, b = mid, k = lo;
            while (a < mid && b < hi)
                tmp[k++] = keys[a] <= keys[b] ? keys[a++] : keys[b++];
            while (a < mid) tmp[k++] = keys[a++];
            while (b < hi) tmp[k++] = keys[b++];
        }
        memcpy(keys, tmp, sizeof(uint64_t) * (size_t)used);
    }
    static __thread uint64_t wleaf[NUM_LITLEN];
    for (int i = 0; i < used; i++) {
        order[i] = (int)(keys[i] & 0xFFFF);
        wleaf[i] = (keys[i] >> 16) << 1;           /* packed, flag 0 */
    }
    /* fast path: plain two-queue Huffman over the sorted leaves is
     * O(used); when its deepest leaf already fits the limit the
     * lengths are optimal-limited too (package-merge degenerates to
     * it), so the 15-level merge below only runs for the rare
     * over-deep case. Leaves win ties (minimum-variance code), which
     * keeps the depth as small as an optimal code allows. */
    {
        static __thread uint64_t nw[2 * NUM_LITLEN];
        static __thread int16_t parent[2 * NUM_LITLEN];
        static __thread uint8_t depth[2 * NUM_LITLEN];
        int a = 0;              /* next leaf */
        int qh = 0, qt = 0;     /* package FIFO: indices into nw */
        for (int m = 0; m < used - 1; m++) {
            int i1, i2;
            /* smallest */
            if (a < used && (qh == qt || wleaf[a] <= nw[qh]))
                i1 = a++;
            else { i1 = used + qh; qh++; }
            /* second smallest */
            if (a < used && (qh == qt || wleaf[a] <= nw[qh]))
                i2 = a++;
            else { i2 = used + qh; qh++; }
            uint64_t w1 = i1 < used ? wleaf[i1] >> 1 : nw[i1 - used] >> 1;
            uint64_t w2 = i2 < used ? wleaf[i2] >> 1 : nw[i2 - used] >> 1;
            nw[qt] = (w1 + w2) << 1;
            parent[i1 < used ? i1 : used + (i1 - used)] =
                (int16_t)(used + qt);
            parent[i2 < used ? i2 : used + (i2 - used)] =
                (int16_t)(used + qt);
            qt++;
        }
        /* root = used + qt - 1; depths top-down in reverse creation
         * order (parents are always created after children) */
        depth[used + qt - 1] = 0;
        for (int m = qt - 2; m >= 0; m--)
            depth[used + m] = (uint8_t)(depth[parent[used + m]] + 1);
        int maxd = 0;
        for (int i = 0; i < used; i++) {
            int d = depth[parent[i]] + 1;
            if (d > maxd) maxd = d;
        }
        if (maxd <= limit) {
            for (int i = 0; i < used; i++)
                lens[order[i]] = (uint8_t)(depth[parent[i]] + 1);
            return 0;
        }
    }
    static __thread uint64_t lv[16][2 * NUM_LITLEN];
    int lvn[16];
    memcpy(lv[1], wleaf, sizeof(uint64_t) * (size_t)used);
    lvn[1] = used;
    for (int l = 2; l <= limit; l++) {
        int npack = lvn[l - 1] / 2;
        const uint64_t *prev = lv[l - 1];
        uint64_t *dst = lv[l];
        int a = 0, b = 0, k = 0;
        while (a < used && b < npack) {
            uint64_t pw = ((prev[2 * b] >> 1) + (prev[2 * b + 1] >> 1))
                << 1 | 1;
            if (wleaf[a] <= pw)
                dst[k++] = wleaf[a++];
            else { dst[k++] = pw; b++; }
        }
        while (a < used) dst[k++] = wleaf[a++];
        while (b < npack) {
            dst[k++] = (((prev[2 * b] >> 1) + (prev[2 * b + 1] >> 1))
                        << 1) | 1;
            b++;
        }
        lvn[l] = k;
    }
    /* downward prefix count */
    int nl_count[NUM_LITLEN + 1];
    memset(nl_count, 0, sizeof(int) * (size_t)(used + 1));
    int take = 2 * (used - 1);
    for (int l = limit; l >= 1 && take > 0; l--) {
        if (take > lvn[l]) take = lvn[l];
        int p = 0;
        const uint64_t *cur = lv[l];
        for (int i = 0; i < take; i++) p += (int)(cur[i] & 1);
        int nleaf = take - p;
        nl_count[nleaf]++;
        take = 2 * p;
    }
    int run = 0;
    for (int i = used - 1; i >= 0; i--) {
        run += nl_count[i + 1];
        lens[order[i]] = (uint8_t)run;
    }
    return 0;
}

/* canonical codes, bit-reversed for LSB-first emission */
static void canonical_codes(const uint8_t *lens, int n, uint16_t *codes) {
    int counts[16] = {0};
    for (int i = 0; i < n; i++) counts[lens[i]]++;
    counts[0] = 0;
    int next[17]; int code = 0;
    for (int l = 1; l <= 15; l++) { code = (code + counts[l - 1]) << 1; next[l] = code; }
    for (int i = 0; i < n; i++) {
        int l = lens[i];
        if (!l) { codes[i] = 0; continue; }
        int c = next[l]++;
        /* constant-time bit reversal via the byte LUT (the naive
         * per-bit loop was 39% of small-call time) */
        codes[i] = (uint16_t)(((REV8[c & 0xFF] << 8)
                               | REV8[(c >> 8) & 0xFF]) >> (16 - l));
    }
}

/* a 1-symbol code is under-subscribed; add a dummy length-1 symbol */
static void ensure_complete(uint8_t *lens, int n) {
    int nz = -1, cnt = 0;
    for (int i = 0; i < n; i++) if (lens[i]) { nz = i; cnt++; }
    if (cnt == 1) { lens[nz] = 1; lens[nz == 0 ? 1 : 0] = 1; }
    if (cnt == 0) { lens[0] = 1; lens[1] = 1; }
}

/* ------------------------------------------------------------------ */
/* encoder                                                             */
/* ------------------------------------------------------------------ */

typedef struct { uint32_t litrun, len, off; } Seq;

typedef struct {
    int32_t head[HASH_SIZE];
    int32_t prev_buf[0]; /* unused marker */
} HashState;

static inline uint32_t hash4(const uint8_t *p, int shift) {
    uint32_t w;
    memcpy(&w, p, 4);
    return (w * 0x9E3779B1u) >> shift;
}

/* SIMD match-length kernels (the reference's capability tier ladder:
 * AVX-512BW > AVX2 > scalar, reference src/compress/matchfinder.rs:
 * 277-719 — own designs, compiled in via -march=native rather than
 * runtime-dispatched since the .so is built on the machine it runs on).
 * All wide loads stay within [p, p+max): no reads past the caller's
 * bound (the AVX-512 tail uses a maskz load, which cannot fault on
 * masked-out lanes). */
#if defined(__AVX512BW__)
static inline uint32_t match_len(const uint8_t *a, const uint8_t *b,
                                 uint32_t max) {
    uint32_t l = 0;
    while (l + 64 <= max) {
        __m512i x = _mm512_loadu_si512((const void *)(a + l));
        __m512i y = _mm512_loadu_si512((const void *)(b + l));
        uint64_t ne = _mm512_cmpneq_epi8_mask(x, y);
        if (ne) return l + (uint32_t)__builtin_ctzll(ne);
        l += 64;
    }
    if (l < max) {
        __mmask64 m = (__mmask64)(~0ULL >> (64 - (max - l)));
        __m512i x = _mm512_maskz_loadu_epi8(m, (const void *)(a + l));
        __m512i y = _mm512_maskz_loadu_epi8(m, (const void *)(b + l));
        uint64_t ne = _mm512_cmpneq_epi8_mask(x, y) & (uint64_t)m;
        if (ne) return l + (uint32_t)__builtin_ctzll(ne);
        l = max;
    }
    return l;
}
#elif defined(__AVX2__)
static inline uint32_t match_len(const uint8_t *a, const uint8_t *b,
                                 uint32_t max) {
    uint32_t l = 0;
    while (l + 32 <= max) {
        __m256i x = _mm256_loadu_si256((const __m256i *)(a + l));
        __m256i y = _mm256_loadu_si256((const __m256i *)(b + l));
        uint32_t eq = (uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(x, y));
        if (eq != 0xFFFFFFFFu) return l + (uint32_t)__builtin_ctz(~eq);
        l += 32;
    }
    while (l + 8 <= max) {
        uint64_t x, y;
        memcpy(&x, a + l, 8);
        memcpy(&y, b + l, 8);
        uint64_t d = x ^ y;
        if (d) return l + (uint32_t)(__builtin_ctzll(d) >> 3);
        l += 8;
    }
    while (l < max && a[l] == b[l]) l++;
    return l;
}
#else
static inline uint32_t match_len(const uint8_t *a, const uint8_t *b,
                                 uint32_t max) {
    uint32_t l = 0;
    while (l + 8 <= max) {
        uint64_t x, y;
        memcpy(&x, a + l, 8);
        memcpy(&y, b + l, 8);
        uint64_t d = x ^ y;
        if (d) return l + (uint32_t)(__builtin_ctzll(d) >> 3);
        l += 8;
    }
    while (l < max && a[l] == b[l]) l++;
    return l;
}
#endif

/* ------------------------------------------------------------------ */
/* adaptive block splitter                                             */
/* ------------------------------------------------------------------ */
/* The reference ends a dynamic block early when the observed symbol
 * distribution drifts (reference src/compress/mod.rs:271-416: 14
 * observation classes, checked every 2048 observations). Fresh design
 * with the same signal classes: 8 literal-MSB buckets, 2 match-length
 * buckets, 4 offset-magnitude buckets; split when the recent window's
 * distribution diverges from the block-so-far by more than 25% (L1). */

#define SPLIT_CHECK_EVERY 2048
#define SPLIT_MIN_BLOCK 5000

typedef struct {
    uint32_t blk[14], rec[14];
    uint32_t blk_total, rec_total;
} Split;

static inline void split_reset(Split *s) { memset(s, 0, sizeof *s); }

static inline void split_obs_lit(Split *s, uint8_t lit) {
    /* sample every other literal at double weight: the distribution
     * estimate the splitter needs is unchanged in expectation, the
     * hot-loop cost halves */
    if (s->rec_total & 1) s->rec[lit >> 5] += 2;
    s->rec_total++;
}

static inline void split_obs_match(Split *s, uint32_t len, uint32_t off) {
    s->rec[8 + (len >= 16)]++;
    int b = (31 - __builtin_clz(off)) >> 2;
    s->rec[10 + (b > 3 ? 3 : b)]++;
    s->rec_total += 2;
}

static inline int split_check(Split *s) {
    int decide = 0;
    if (s->blk_total >= 2 * SPLIT_CHECK_EVERY) {
        int64_t div = 0;
        for (int k = 0; k < 14; k++) {
            int64_t d = (int64_t)s->rec[k] * s->blk_total
                - (int64_t)s->blk[k] * s->rec_total;
            if (d < 0) d = -d;
            div += d / s->blk_total;   /* deviation in recent-window units */
        }
        decide = div * 4 > (int64_t)s->rec_total;
    }
    for (int k = 0; k < 14; k++) { s->blk[k] += s->rec[k]; s->rec[k] = 0; }
    s->blk_total += s->rec_total;
    s->rec_total = 0;
    return decide;
}

/* level -> (strategy greedy=0/lazy=1, depth, nice, lazy2, good,
 * maxlazy). maxlazy is zlib's max_lazy rule: a held match at least
 * this long commits without probing the next position at all (the
 * good rule only shallows the probe); 0 disables for the ratio tiers */
static const int LEVEL_PARAMS[10][6] = {
    {0, 0, 0, 0, 0, 0},
    {2, 2, 16, 0, 0, 0}, {0, 8, 16, 0, 0, 0}, {0, 24, 32, 0, 0, 0},
    {0, 48, 64, 0, 0, 0},
    /* L6 depth 64 (was 128): the chain walk's dependent link loads are
     * the measured hot spot (44% of samples); halving depth trades
     * 0.4% ratio (silesia 3.0582 -> 3.0456, still above libdeflate-6's
     * 3.018) for ~+27% throughput. MLP variants (2-lane skip links,
     * prefetch, chunked walks) all measured flat — the retune is the
     * lever that moves. */
    {1, 32, 64, 0, 4, 16}, {1, 64, 128, 0, 8, 16},
    {1, 256, 160, 1, 16, 64},
    {1, 1024, 258, 1, 32, 0}, {1, 4096, 258, 1, 64, 0},
};

typedef struct {
    const uint8_t *buf;
    int64_t n;
    int32_t *head;   /* 1 << hb (hash4 chains) */
    int32_t *head3;  /* 1 << hb (hash3 single probe) */
    uint16_t *prev16; /* WINDOW-sized ring of u16 delta links */
    int depth, nice, lazy, lazy2;
    int good;     /* zlib-style: held match >= good => depth >> 2 */
    int maxlazy;  /* held match >= maxlazy => commit, no probe */
    int h3;       /* maintain the hash3 single-probe table */
    int ht;       /* bucket (HT) tier: 2-entry buckets, no chains */
    int hshift;      /* 32 - hb: tables sized to the input so small
                      * calls don't pay a 256 KB clear */
} MF;

/* hash-table bits for an input of n bytes (clears scale with n) */
static inline int hash_bits_for(int64_t n) {
    if (n >= 32768) return HASH_BITS;
    int hb = 10;
    while ((1 << hb) < (int)n && hb < HASH_BITS) hb++;
    return hb;
}

static inline uint32_t hash3(const uint8_t *p, int shift) {
    uint32_t w;
    memcpy(&w, p, 4);
    return ((w & 0xFFFFFF) * 0x9E3779B1u) >> shift;
}

/* insert position i (hash precomputed) and return the previous chain
 * head — fusing the probe's chain start with the insertion so each
 * position hashes its 4 bytes exactly once */
static inline int32_t mf_insert_get(MF *m, int64_t i, uint32_t h) {
    int32_t old = m->head[h];
    uint64_t d = (uint64_t)(i - old);
    m->prev16[i & (WINDOW - 1)] =
        (old < 0 || d > 0xFFFF) ? 0 : (uint16_t)d;
    m->head[h] = (int32_t)i;
    if (m->h3)
        m->head3[hash3(m->buf + i, m->hshift)] = (int32_t)i;
    return old;
}

static inline void mf_insert(MF *m, int64_t i) {
    if (i + MIN_MATCH + 1 > m->n) return;
    mf_insert_get(m, i, hash4(m->buf + i, m->hshift));
}

/* walk the chain starting at j (the head BEFORE i was inserted) */
static inline uint32_t mf_walk(MF *m, int64_t i, int32_t j, uint32_t max,
                               uint32_t *off_out, int depth) {
    if (max < 3) return 0;
    const uint8_t *base = m->buf;
    const uint8_t *in = base + i;
    uint32_t best = 0, boff = 0;
    if (max >= 4) {
        /* candidate filter: one u32 load at in+best-3 rejects any
         * candidate that cannot beat the current best, one u32 load at
         * the candidate start confirms the first 4 bytes, and the full
         * compare then extends from byte 4 (the reference's first-byte
         * screen, reference src/compress/matchfinder.rs:812-888,
         * sharpened to 4-byte screens). best starts at 3 so the
         * best-3 screen initially IS the first-4 screen. */
        uint32_t first4, want;
        memcpy(&first4, in, 4);
        want = first4;
        uint32_t b3 = 3; /* screen position = b3 - 3 */
        uint32_t maxoff = i > WINDOW ? WINDOW : (uint32_t)i;
        if (j >= 0) {
            uint32_t off = (uint32_t)(i - j);
            int d = depth;
            while (off <= maxoff && d-- > 0) {
                uint32_t have, f;
                memcpy(&have, base + j + b3 - 3, 4);
                if (have == want) {
                    memcpy(&f, base + j, 4);
                    if (f == first4) {
                        uint32_t l = 4 + match_len(base + j + 4, in + 4,
                                                   max - 4);
                        if (l > best) {
                            best = l; boff = off;
                            /* stop on saturation: want at in+best-3
                             * would read past the usable input */
                            if (l >= (uint32_t)m->nice || l >= max)
                                break;
                            b3 = best;
                            memcpy(&want, in + b3 - 3, 4);
                        }
                    }
                }
                uint32_t delta = m->prev16[j & (WINDOW - 1)];
                if (!delta) break;
                j -= (int32_t)delta;
                off += delta;
            }
        }
    }
    if (best >= 4) { *off_out = boff; return best; }
    if (!m->h3) return 0;          /* speed tiers skip 3-byte matches */
    /* fall back to a close length-3 match (single-probe hash3): worth
     * at most when nearby — a far 3-match costs more than 3 literals */
    int32_t j3 = m->head3[hash3(base + i, m->hshift)];
    if (j3 >= 0 && j3 < i && i - j3 <= 1024 && j3 > i - WINDOW
            && base[j3] == base[i] && base[j3 + 1] == base[i + 1]
            && base[j3 + 2] == base[i + 2]) {
        *off_out = (uint32_t)(i - j3);
        return 3;
    }
    return 0;
}

/* bucket matchfinder for the HT speed tier (level 1): one u64 bucket
 * holds the two most recent positions with this hash, so both
 * candidate loads issue in parallel instead of chasing chain links
 * serially (the reference's HT tier design point, reference
 * src/compress/matchfinder.rs:1000-1106, bucket form). The bucket
 * array reuses the chain tiers' head storage (2*HASH_SIZE i32 =
 * HASH_SIZE u64). Probe and insert are fused like mf_insert_get.
 * Measured vs depth-2 chains on the silesia-like corpus: +10%
 * throughput at equal ratio (2.9113 vs 2.9109). */
static inline uint32_t ht_probe_insert(MF *m, int64_t i, uint32_t max,
                                       uint32_t *off_out) {
    uint64_t *tab = (uint64_t *)m->head;
    uint32_t h = hash4(m->buf + i, m->hshift);
    uint64_t ent = tab[h];
    tab[h] = (ent << 32) | (uint32_t)i;
    if (max < 4) return 0;
    const uint8_t *base = m->buf;
    const uint8_t *in = base + i;
    uint32_t first4;
    memcpy(&first4, in, 4);
    int64_t c1 = (int64_t)(int32_t)(uint32_t)ent;
    int64_t c2 = (int64_t)(int32_t)(uint32_t)(ent >> 32);
    uint32_t best = 0, boff = 0;
    /* both candidate loads are independent of each other */
    if (c1 >= 0 && i - c1 <= WINDOW && c1 < i) {
        uint32_t f;
        memcpy(&f, base + c1, 4);
        if (f == first4) {
            best = 4 + match_len(base + c1 + 4, in + 4, max - 4);
            boff = (uint32_t)(i - c1);
            if (best >= (uint32_t)m->nice) { *off_out = boff; return best; }
        }
    }
    if (c2 >= 0 && i - c2 <= WINDOW && c2 < i) {
        /* screen: c2 must beat best, so its bytes at best-3 must match
         * (also implies the first4 check when best <= 3) */
        uint32_t b3 = best > 4 ? best : 4;
        uint32_t have, want;
        memcpy(&have, base + c2 + b3 - 3, 4);
        memcpy(&want, in + b3 - 3, 4);
        if (have == want) {
            uint32_t f;
            memcpy(&f, base + c2, 4);
            if (f == first4) {
                uint32_t l = 4 + match_len(base + c2 + 4, in + 4, max - 4);
                if (l > best) {
                    best = l;
                    boff = (uint32_t)(i - c2);
                }
            }
        }
    }
    *off_out = boff;
    return best;
}

static inline void ht_insert(MF *m, int64_t i) {
    if (i + MIN_MATCH + 1 > m->n) return;
    uint64_t *tab = (uint64_t *)m->head;
    uint32_t h = hash4(m->buf + i, m->hshift);
    tab[h] = (tab[h] << 32) | (uint32_t)i;
}

/* emit one block given sequences; chooses stored/static/dynamic */
static void static_lens(uint8_t *ll, uint8_t *of) {
    for (int i = 0; i < 144; i++) ll[i] = 8;
    for (int i = 144; i < 256; i++) ll[i] = 9;
    for (int i = 256; i < 280; i++) ll[i] = 7;
    for (int i = 280; i < 288; i++) ll[i] = 8;
    for (int i = 0; i < 32; i++) of[i] = 5;
}

typedef struct {
    uint8_t psyms[NUM_LITLEN + NUM_OFFSET + 8];
    uint8_t pev[NUM_LITLEN + NUM_OFFSET + 8];
    uint8_t peb[NUM_LITLEN + NUM_OFFSET + 8];
    int np;
    uint8_t pre_lens[NUM_PRECODE];
    uint16_t pre_codes[NUM_PRECODE];
    int num_explicit;
    int hdr_bits;
} DynHdr;

static int build_dyn_header(const uint8_t *ll_lens, const uint8_t *of_lens,
                            int num_ll, int num_of, DynHdr *h) {
    uint8_t all[NUM_LITLEN + NUM_OFFSET];
    int n = num_ll + num_of;
    memcpy(all, ll_lens, (size_t)num_ll);
    memcpy(all + num_ll, of_lens, (size_t)num_of);
    h->np = 0;
    int i = 0, prev = -1;
    while (i < n) {
        int v = all[i], run = 1;
        while (i + run < n && all[i + run] == v) run++;
        int r = run;
        if (v == 0) {
            while (r >= 11) {
                int take = r > 138 ? 138 : r;
                h->psyms[h->np] = 18; h->pev[h->np] = (uint8_t)(take - 11);
                h->peb[h->np++] = 7; r -= take;
            }
            while (r >= 3) {
                int take = r > 10 ? 10 : r;
                h->psyms[h->np] = 17; h->pev[h->np] = (uint8_t)(take - 3);
                h->peb[h->np++] = 3; r -= take;
            }
            for (; r > 0; r--) {
                h->psyms[h->np] = 0; h->pev[h->np] = 0; h->peb[h->np++] = 0;
            }
        } else {
            if (v != prev) {
                h->psyms[h->np] = (uint8_t)v; h->pev[h->np] = 0;
                h->peb[h->np++] = 0; r--;
            }
            while (r >= 3) {
                int take = r > 6 ? 6 : r;
                h->psyms[h->np] = 16; h->pev[h->np] = (uint8_t)(take - 3);
                h->peb[h->np++] = 2; r -= take;
            }
            for (; r > 0; r--) {
                h->psyms[h->np] = (uint8_t)v; h->pev[h->np] = 0;
                h->peb[h->np++] = 0;
            }
        }
        prev = v;
        i += run;
    }
    uint64_t pf[NUM_PRECODE] = {0};
    for (int k = 0; k < h->np; k++) pf[h->psyms[k]]++;
    if (pm_lengths(pf, NUM_PRECODE, MAX_PRE_LEN, h->pre_lens))
        return ERR_BADDATA;
    ensure_complete(h->pre_lens, NUM_PRECODE);
    canonical_codes(h->pre_lens, NUM_PRECODE, h->pre_codes);
    int ne = NUM_PRECODE;
    while (ne > 4 && h->pre_lens[PRE_PERM[ne - 1]] == 0) ne--;
    h->num_explicit = ne;
    int bits = 5 + 5 + 4 + 3 * ne;
    for (int k = 0; k < h->np; k++)
        bits += h->pre_lens[h->psyms[k]] + h->peb[k];
    h->hdr_bits = bits;
    return 0;
}

static void write_block(BitW *w, const uint8_t *data, int64_t start,
                        int64_t end, const Seq *seqs, int nseq,
                        int final, int64_t *size_acc) {
    /* literals are read straight from the input via the seq walk
     * (litrun literals, then len match bytes, per seq) — the previous
     * side buffer cost a store per literal in the parse loop plus two
     * extra passes here */
    /* frequencies */
    uint64_t llf[NUM_LITLEN] = {0}, off_f[NUM_OFFSET] = {0};
    {
        const uint8_t *lp = data + start;
        for (int s = 0; s < nseq; s++) {
            for (uint32_t k = 0; k < seqs[s].litrun; k++) llf[lp[k]]++;
            lp += seqs[s].litrun + seqs[s].len;
            if (seqs[s].len) {
                llf[257 + LEN2SYM[seqs[s].len]]++;
                off_f[off2sym(seqs[s].off)]++;
            }
        }
    }
    llf[256]++;
    uint8_t dll[NUM_LITLEN], dof[NUM_OFFSET];
    if (pm_lengths(llf, NUM_LITLEN, MAX_LL_LEN, dll)
            || pm_lengths(off_f, NUM_OFFSET, MAX_OF_LEN, dof)) {
        w->error = ERR_BADDATA;
        return;
    }
    ensure_complete(dll, NUM_LITLEN);
    ensure_complete(dof, 30);
    int num_ll = NUM_LITLEN;
    while (num_ll > 257 && dll[num_ll - 1] == 0) num_ll--;
    int num_of = 30;
    while (num_of > 1 && dof[num_of - 1] == 0) num_of--;
    DynHdr hdr;
    if (build_dyn_header(dll, dof, num_ll, num_of, &hdr)) {
        w->error = ERR_BADDATA;
        return;
    }

    uint8_t sll[NUM_LITLEN], sof[NUM_OFFSET];
    static_lens(sll, sof);
    int64_t body_dyn = 0, body_static = 0;
    for (int s = 0; s < NUM_LITLEN; s++) {
        int64_t extra = (s >= 257 && s <= 285) ? LEN_EXTRA[s - 257] : 0;
        body_dyn += (int64_t)llf[s] * (dll[s] + extra);
        body_static += (int64_t)llf[s] * (sll[s] + extra);
    }
    for (int s = 0; s < 30; s++) {
        body_dyn += (int64_t)off_f[s] * (dof[s] + OFF_EXTRA[s]);
        body_static += (int64_t)off_f[s] * (sof[s] + OFF_EXTRA[s]);
    }
    int64_t raw = end - start;
    int64_t cost_dyn = 3 + hdr.hdr_bits + body_dyn;
    int64_t cost_static = 3 + body_static;
    int64_t nstored = raw / 65535 + 1;
    int64_t cost_stored = nstored * 40 + raw * 8 + 7;

    if (size_acc) {
        /* cost-only mode (the reference's compress_to_size estimator,
         * reference src/compress/mod.rs:792-1094, made exact): the
         * SAME election as the emit path below, with stored-block
         * alignment resolved against the running bit position, so the
         * accumulated size equals the emitted stream's bit-for-bit. */
        if (cost_stored < cost_dyn && cost_stored < cost_static) {
            int64_t b = *size_acc, pos = start;
            do {
                int64_t chunk = end - pos > 65535 ? 65535 : end - pos;
                b += 3;
                b = (b + 7) & ~7LL;       /* bw_align */
                b += 32 + chunk * 8;      /* LEN/NLEN + payload */
                pos += chunk;
            } while (pos < end);
            *size_acc = b;
        } else {
            *size_acc += cost_static <= cost_dyn ? cost_static
                                                 : cost_dyn;
        }
        return;
    }

    if (cost_stored < cost_dyn && cost_stored < cost_static) {
        int64_t pos = start;
        do {
            int64_t chunk = end - pos > 65535 ? 65535 : end - pos;
            int last = (pos + chunk == end);
            bw_put(w, (final && last) ? 1 : 0, 3); /* BTYPE=00 */
            bw_align(w);
            bw_put(w, (uint32_t)chunk, 16);
            bw_put(w, (uint32_t)(~chunk & 0xFFFF), 16);
            bw_flushbytes(w);
            if (w->out + chunk > w->end) { w->overflow = 1; return; }
            memcpy(w->out, data + pos, (size_t)chunk);
            w->out += chunk;
            pos += chunk;
        } while (pos < end);
        return;
    }

    const uint8_t *ll_lens;
    const uint8_t *of_lens;
    uint16_t ll_codes[NUM_LITLEN], of_codes[NUM_OFFSET];
    if (cost_static <= cost_dyn) {
        bw_put(w, (final ? 1 : 0) | 2, 3); /* BTYPE=01 */
        ll_lens = sll; of_lens = sof;
    } else {
        bw_put(w, (final ? 1 : 0) | 4, 3); /* BTYPE=10 */
        bw_put(w, (uint32_t)(num_ll - 257), 5);
        bw_put(w, (uint32_t)(num_of - 1), 5);
        bw_put(w, (uint32_t)(hdr.num_explicit - 4), 4);
        for (int k = 0; k < hdr.num_explicit; k++)
            bw_put(w, hdr.pre_lens[PRE_PERM[k]], 3);
        for (int k = 0; k < hdr.np; k++) {
            int s = hdr.psyms[k];
            bw_put(w, hdr.pre_codes[s], hdr.pre_lens[s]);
            if (hdr.peb[k]) bw_put(w, hdr.pev[k], hdr.peb[k]);
        }
        ll_lens = dll; of_lens = dof;
    }
    canonical_codes(ll_lens, NUM_LITLEN, ll_codes);
    canonical_codes(of_lens, NUM_OFFSET, of_codes);

    /* packed emit tables (the reference's packed-u64 sequence emitter
     * idea, reference src/compress/mod.rs:1918-2051, re-derived): a
     * literal is one fused <=14-bit write; a match length fuses symbol
     * code + extra bits into <=19, an offset into <=28 — so 4 literals
     * or one whole match fit the 64-bit buffer after one byte-aligned
     * flush. */
    uint32_t llp[256];
    for (int b = 0; b < 256; b++)
        llp[b] = ll_codes[b] | ((uint32_t)ll_lens[b] << 16);
    uint32_t lenp[MAX_MATCH + 1];
    uint8_t lenb[MAX_MATCH + 1];
    for (int l = MIN_MATCH; l <= MAX_MATCH; l++) {
        int s2 = LEN2SYM[l], cl = ll_lens[257 + s2];
        lenp[l] = ll_codes[257 + s2]
            | ((uint32_t)(l - LEN_BASE[s2]) << cl);
        lenb[l] = (uint8_t)(cl + LEN_EXTRA[s2]);
    }
    const uint8_t *lp = data + start;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    {
        uint64_t bb = w->buf;
        unsigned nb = (unsigned)w->n;
        uint8_t *out = w->out;
        uint8_t *safe = w->end - 8;  /* room for one blind 8-byte store */
        /* blind 8-byte store, advance by whole bytes */
#define LD_FLUSH8() do { memcpy(out, &bb, 8); out += nb >> 3; \
            bb >>= (nb & ~7u); nb &= 7u; } while (0)
        for (int s = 0; s < nseq; s++) {
            uint32_t run = seqs[s].litrun;
            while (run >= 4) {
                if (out > safe) goto spill;
                LD_FLUSH8();
                uint32_t e0 = llp[lp[0]], e1 = llp[lp[1]];
                uint32_t e2 = llp[lp[2]], e3 = llp[lp[3]];
                bb |= (uint64_t)(uint16_t)e0 << nb; nb += e0 >> 16;
                bb |= (uint64_t)(uint16_t)e1 << nb; nb += e1 >> 16;
                bb |= (uint64_t)(uint16_t)e2 << nb; nb += e2 >> 16;
                bb |= (uint64_t)(uint16_t)e3 << nb; nb += e3 >> 16;
                lp += 4; run -= 4;
            }
            if (out > safe) goto spill;
            LD_FLUSH8();
            while (run) {        /* <=3 * 14 = 42 bits on a clean buffer */
                uint32_t e = llp[*lp++];
                bb |= (uint64_t)(uint16_t)e << nb; nb += e >> 16;
                run--;
            }
            if (seqs[s].len) {   /* whole match <=47 bits: len 19, off 28 */
                if (nb > 16) { if (out > safe) goto spill; LD_FLUSH8(); }
                uint32_t l = seqs[s].len, o = seqs[s].off;
                bb |= (uint64_t)lenp[l] << nb; nb += lenb[l];
                int os = off2sym(o);
                bb |= (uint64_t)(of_codes[os]
                        | ((o - OFF_BASE[os]) << of_lens[os])) << nb;
                nb += of_lens[os] + OFF_EXTRA[os];
                lp += l;
            }
            continue;
        spill:
            /* near the end of the output buffer: hand the pending bits
             * back and finish this seq + the rest fully checked */
            w->buf = bb; w->n = (int)nb; w->out = out;
            for (; s < nseq; s++) {
                /* first iteration: the literals still pending for seq s */
                for (uint32_t k = run; k > 0; k--) {
                    uint8_t b = *lp++;
                    bw_put(w, ll_codes[b], ll_lens[b]);
                }
                run = s + 1 < nseq ? seqs[s + 1].litrun : 0;
                if (seqs[s].len) {
                    int ls = LEN2SYM[seqs[s].len];
                    bw_put(w, ll_codes[257 + ls], ll_lens[257 + ls]);
                    if (LEN_EXTRA[ls])
                        bw_put(w, seqs[s].len - LEN_BASE[ls], LEN_EXTRA[ls]);
                    int os = off2sym(seqs[s].off);
                    bw_put(w, of_codes[os], of_lens[os]);
                    if (OFF_EXTRA[os])
                        bw_put(w, seqs[s].off - OFF_BASE[os], OFF_EXTRA[os]);
                    lp += seqs[s].len;
                }
                bw_flushbytes(w);
            }
            bw_put(w, ll_codes[256], ll_lens[256]); /* EOB */
            bw_flushbytes(w);
            return;
        }
        if (out > safe) {
            w->buf = bb; w->n = (int)nb; w->out = out;
        } else {
            LD_FLUSH8();
            w->buf = bb; w->n = (int)nb; w->out = out;
        }
#undef LD_FLUSH8
    }
#else
    for (int s = 0; s < nseq; s++) {
        for (uint32_t k = 0; k < seqs[s].litrun; k++) {
            uint8_t b = *lp++;
            bw_put(w, ll_codes[b], ll_lens[b]);
        }
        if (seqs[s].len) {
            int ls = LEN2SYM[seqs[s].len];
            bw_put(w, ll_codes[257 + ls], ll_lens[257 + ls]);
            if (LEN_EXTRA[ls])
                bw_put(w, seqs[s].len - LEN_BASE[ls], LEN_EXTRA[ls]);
            int os = off2sym(seqs[s].off);
            bw_put(w, of_codes[os], of_lens[os]);
            if (OFF_EXTRA[os])
                bw_put(w, seqs[s].off - OFF_BASE[os], OFF_EXTRA[os]);
            lp += seqs[s].len;
        }
        bw_flushbytes(w);
    }
#endif
    bw_put(w, ll_codes[256], ll_lens[256]); /* EOB */
    bw_flushbytes(w);
}

/* -------- near-optimal DP parser (levels 10-12) ---------------------- */
/* The reference's two-pass scheme (reference src/compress/mod.rs:
 * 1586-1773): collect Pareto matches per position, shortest-path DP over
 * bit costs with a static-code cost model, then refresh costs from the
 * implied Huffman code and re-parse. Fresh implementation. */

#define MAXC 12  /* Pareto candidates kept per position */

typedef struct { uint16_t len; uint16_t dummy; uint32_t off; } Cand;

/* Binary-tree matchfinder for the DP tiers (levels 10-12): each hash4
 * bucket holds a binary search tree of positions ordered by suffix;
 * one walk both finds all Pareto matches and re-roots the tree at the
 * new position (classic LZMA/libdeflate BT scheme; the reference's BT
 * tier is src/compress/matchfinder.rs:1308-1776). Two properties make
 * it strictly better than chain walks on repetitive data: comparisons
 * resume from min(best_lt, best_gt) instead of byte 0, and a saturated
 * match (len >= max or nice) terminates the walk by sewing the node's
 * subtrees into place — O(1) per position inside long runs. */
typedef struct {
    const uint8_t *buf;
    int64_t n;
    int32_t *head;    /* hash4 -> tree root (most recent position) */
    int32_t *head3;   /* hash3 single probe */
    int32_t *child;   /* ring of 2*RING entries: [2(i&RM)] l, [..+1] r.
                       * Links are absolute positions; the window is
                       * 32 KiB < RING, so live positions never share a
                       * slot, and a stale read yields an old position
                       * that fails the `cur > limit` check. Keeps the
                       * hot working set at 512 KiB (L2) instead of
                       * 8 B x input length. */
    int hshift;
    int depth, nice;
    int maxc;     /* Pareto candidates recorded per position */
    int h3;       /* maintain + probe the hash3 table (DP tiers only) */
} BT;

static int bt_find_insert(BT *t, int64_t i, uint32_t rec_max, Cand *out,
                          int record) {
    const uint8_t *base = t->buf;
    int nc = 0;
    if (i + MIN_MATCH + 1 > t->n) return 0;
    /* tree comparisons ALWAYS use the full available length: a walk
     * clamped by a caller-side cap (block boundary) would sew nodes
     * that agree on only the capped prefix, corrupting BST order for
     * later full-length searches. rec_max caps only what is REPORTED. */
    uint32_t max = (uint32_t)(t->n - i);
    if (max > MAX_MATCH) max = MAX_MATCH;
    int64_t limit = i - WINDOW;
    if (t->h3) {
        if (record && rec_max >= 3) {
            int32_t j3 = t->head3[hash3(base + i, t->hshift)];
            if (j3 >= 0 && j3 < i && i - j3 <= WINDOW && j3 > limit
                    && base[j3] == base[i] && base[j3 + 1] == base[i + 1]
                    && base[j3 + 2] == base[i + 2]) {
                out[nc].len = 3;
                out[nc].off = (uint32_t)(i - j3);
                nc++;
            }
        }
        t->head3[hash3(base + i, t->hshift)] = (int32_t)i;
    }
    uint32_t h = hash4(base + i, t->hshift);
    int32_t cur = t->head[h];
    t->head[h] = (int32_t)i;
    int32_t *lt = &t->child[2 * (i & MF_RM)],
            *gt = &t->child[2 * (i & MF_RM) + 1];
    uint32_t best_lt = 0, best_gt = 0, best = 3;
    int d = t->depth;
    for (;;) {
        if (cur < 0 || cur <= limit || d-- <= 0) {
            *lt = -1;
            *gt = -1;
            break;
        }
        uint32_t len = best_lt < best_gt ? best_lt : best_gt;
        len += match_len(base + cur + len, base + i + len, max - len);
        if (record && rec_max >= 4 && nc < t->maxc) {
            uint32_t lr = len < rec_max ? len : rec_max;
            if (lr >= 4 && lr > best) {
                out[nc].len = (uint16_t)lr;
                out[nc].off = (uint32_t)(i - cur);
                nc++;
                best = lr;
            }
        }
        if (len >= max || len >= (uint32_t)t->nice) {
            /* saturated at the full compare length: the node is
             * interchangeable with i for every future search — adopt
             * its subtrees and stop */
            *lt = t->child[2 * (cur & MF_RM)];
            *gt = t->child[2 * (cur & MF_RM) + 1];
            break;
        }
        if (base[cur + len] < base[i + len]) {
            *lt = cur;
            lt = &t->child[2 * (cur & MF_RM) + 1];
            cur = *lt;
            best_lt = len;
        } else {
            *gt = cur;
            gt = &t->child[2 * (cur & MF_RM)];
            cur = *gt;
            best_gt = len;
        }
    }
    return nc;
}


static void optimal_parse(const uint8_t *buf, int64_t bstart,
                          int64_t bend, int64_t n_total,
                          const uint8_t *ll_cost, const uint8_t *of_cost,
                          Cand *cands, uint8_t *ncand,
                          uint16_t *choice_len, uint32_t *choice_off,
                          uint32_t *cost) {
    int64_t n = bend - bstart;
    /* fused per-length bit cost (symbol code + extra bits), rebuilt per
     * pass: turns the hot inner relaxation into 3 loads + add + cmp */
    uint16_t lenc[MAX_MATCH + 1];
    for (uint32_t l = MIN_MATCH - 1; l <= MAX_MATCH; l++) {
        int ls = LEN2SYM[l];
        lenc[l] = (uint16_t)(ll_cost[257 + ls] + LEN_EXTRA[ls]);
    }
    cost[n] = 0;
    for (int64_t i = n - 1; i >= 0; i--) {
        int64_t p = bstart + i;
        /* relax as one u64 min-reduction over packed
         * (cost << 24 | offset << 9 | len) values — the fields cannot
         * carry into each other (len < 512, offset < 32768 shifted
         * clear of len, block cost < 2^40), so the numeric minimum is
         * the cheapest choice with smaller offset/len as tie-breaks;
         * a single min chain lets the compiler use vpminuq lanes where
         * the scalar compare-and-branch version could not vectorize */
        uint64_t bestp =
            ((uint64_t)(ll_cost[buf[p]] + cost[i + 1]) << 24) | 1;
        const Cand *c = cands + (size_t)i * MAXC;
        uint32_t prev_len = 2;
        for (int k = 0; k < ncand[i]; k++) {
            uint32_t off = c[k].off;
            int os = off2sym(off);
            uint32_t oc = of_cost[os] + OFF_EXTRA[os];
            const uint32_t *cp = cost + i;
            /* clamp: a sampled-prefix parse (and an early split cut)
             * may end before a candidate's full reach */
            uint32_t lmax = c[k].len;
            if (lmax > (uint32_t)(n - i)) lmax = (uint32_t)(n - i);
            uint64_t qq = ((uint64_t)oc << 24) + ((uint64_t)off << 9);
            for (uint32_t l = prev_len + 1; l <= lmax; l++) {
                uint64_t v = qq + ((uint64_t)(lenc[l] + cp[l]) << 24) + l;
                if (v < bestp) bestp = v;
            }
            prev_len = c[k].len;
        }
        cost[i] = (uint32_t)(bestp >> 24);
        choice_len[i] = (uint16_t)(bestp & 0x1FF);
        choice_off[i] = (uint32_t)((bestp >> 9) & 0x7FFF);
    }
    (void)n_total;
}

static int64_t deflate_optimal(const uint8_t *buf, int64_t hist_len,
                               int64_t total_len, int level, int flush,
                               uint8_t *out, int64_t out_cap,
                               int32_t *work) {
    BitW w;
    bw_init(&w, out, out_cap);
    w.n = (flush >> 4) & 7;
    flush &= 15;
    int64_t n = total_len;
    BT bt;
    int hb = hash_bits_for(n);
    bt.buf = buf; bt.n = n;
    bt.head = work;
    bt.head3 = work + (1 << hb);
    bt.hshift = 32 - hb;
    bt.depth = level == 10 ? 12 : (level == 11 ? 48 : 96);
    bt.maxc = level == 10 ? 6 : MAXC;
    bt.h3 = 1;
    bt.nice = MAX_MATCH;
    memset(work, -1, sizeof(int32_t) << (hb + 1));

    int64_t maxb = SOFT_BLOCK;
    Cand *cands = malloc(sizeof(Cand) * (size_t)maxb * MAXC);
    uint8_t *ncand = malloc((size_t)maxb);
    uint16_t *choice_len = malloc(sizeof(uint16_t) * (size_t)maxb);
    uint32_t *choice_off = malloc(sizeof(uint32_t) * (size_t)maxb);
    uint32_t *cost = malloc(sizeof(uint32_t) * ((size_t)maxb + 1));
    Seq *seqs = malloc(sizeof(Seq) * ((size_t)maxb / 3 + 16));
    bt.child = malloc(sizeof(int32_t) * 2 * MF_RING);
    if (!cands || !ncand || !choice_len || !choice_off || !cost
            || !seqs || !bt.child) {
        free(cands); free(ncand); free(choice_len); free(choice_off);
        free(cost); free(seqs); free(bt.child);
        return ERR_BADDATA;
    }
    for (int64_t i = 0; i < hist_len; i++)
        bt_find_insert(&bt, i, 0, NULL, 0);

    int64_t bstart = hist_len;
    /* cost-model warm start: the first pass of block k reuses block
     * k-1's converged Huffman costs (blocks are statistically close);
     * only the very first block seeds from the static code. Measured
     * on the silesia-like corpus: +2.1% ratio at L10, +1.65% at L11,
     * +1.1% at L12 at unchanged speed — worth more than any extra
     * refinement pass (and allows fewer passes below). */
    uint8_t llc[NUM_LITLEN], ofc[NUM_OFFSET];
    static_lens(llc, ofc);
    while (bstart < n) {
        int64_t bend = bstart + maxb < n ? bstart + maxb : n;
        /* collect Pareto matches per position; the adaptive splitter
         * watches the greedy-choice distribution and may cut the block
         * early (the reference runs its splitter in the DP tier's
         * pass-1 scan, reference src/compress/mod.rs:1594-1627) */
        Split sp;
        split_reset(&sp);
        for (int64_t i = bstart; i < bend; i++) {
            if (sp.rec_total >= SPLIT_CHECK_EVERY
                    && split_check(&sp) && i - bstart >= SPLIT_MIN_BLOCK) {
                bend = i;
                break;
            }
            uint32_t maxl = (uint32_t)(n - i);
            if (maxl > MAX_MATCH) maxl = MAX_MATCH;
            if ((uint32_t)(bend - i) < maxl) maxl = (uint32_t)(bend - i);
            int nc = bt_find_insert(&bt, i, maxl,
                                    cands + (i - bstart) * MAXC, 1);
            ncand[i - bstart] = (uint8_t)nc;
            if (nc) {
                const Cand *c = cands + (i - bstart) * MAXC;
                split_obs_match(&sp, c[nc - 1].len, c[nc - 1].off);
            } else {
                split_obs_lit(&sp, buf[i]);
            }
            if (nc && cands[(i - bstart) * MAXC + nc - 1].len
                    >= (level == 10 ? 64 : 128)) {
                /* long match: skip interior (it will be taken whole);
                 * the speed tier also inserts interiors with a shallow
                 * walk — they are rarely better match sources than the
                 * match's own start */
                uint32_t l = cands[(i - bstart) * MAXC + nc - 1].len;
                int64_t stop = i + l < bend ? i + l : bend;
                int save_d = bt.depth;
                int64_t step = 1;
                if (level == 10) {
                    bt.depth = 8;
                    /* long-repeat interiors are near-identical match
                     * sources: a stride subset keeps the tree useful
                     * at a fraction of the match_len compare cost
                     * (the chain tiers' sparse body insert). Measured:
                     * pattern corpus +75% speed at ratio 44.0 (vs
                     * libdeflate-10's 41.2 on the same data), silesia
                     * -0.08% ratio. L11/12 keep full inserts. */
                    step = l >= 128 ? 4 : 2;
                }
                for (int64_t q = i + 1; q < stop; q += step)
                    bt_find_insert(&bt, q, 0, NULL, 0);
                for (int64_t q = i + 1; q < stop; q++)
                    ncand[q - bstart] = 0;
                bt.depth = save_d;
                i = stop - 1;
            }
        }
        int64_t bn = bend - bstart;
        /* an early cut can strand candidates reaching past it: clamp */
        for (int64_t q = 0; q < bn; q++) {
            uint32_t cap = (uint32_t)(bn - q);
            Cand *c = cands + (size_t)q * MAXC;
            int nc = ncand[q], k2 = 0;
            for (int k = 0; k < nc; k++) {
                uint16_t l = c[k].len > cap ? (uint16_t)cap : c[k].len;
                if (l >= 3 && (k2 == 0 || l > c[k2 - 1].len)) {
                    c[k2].len = l;
                    c[k2].off = c[k].off;
                    k2++;
                }
            }
            ncand[q] = (uint8_t)k2;
        }
        int nseq = 0;

        /* with the warm start, pass counts converge much earlier:
         * measured plateau is npass 4 at L12 (3.2211 vs 3.2215 at 5,
         * +13% speed) and npass 2 at L11 (3.2150; a third pass buys
         * +0.14% for -25% speed) */
        int npass = level >= 12 ? 4 : 2;
        for (int pass = 0; pass < npass; pass++) {
            /* level 10 (the DP family's speed tier): the cost-seeding
             * pass parses only a 64 KiB prefix sample — symbol
             * statistics stabilise long before that, and the full
             * block is DP'd once with the refined costs */
            int64_t pend = bend;
            if (level == 10 && pass < npass - 1
                    && bstart + 65536 < bend)
                pend = bstart + 65536;
            int64_t pn = pend - bstart;
            optimal_parse(buf, bstart, pend, n, llc, ofc, cands,
                          ncand, choice_len, choice_off, cost);
            /* walk the chosen path into sequences */
            nseq = 0;
            uint32_t litrun = 0;
            uint64_t llf[NUM_LITLEN] = {0}, off_f[NUM_OFFSET] = {0};
            int64_t i = 0;
            while (i < pn) {
                if (choice_off[i] == 0) {
                    llf[buf[bstart + i]]++;
                    litrun++;
                    i += 1;
                } else {
                    seqs[nseq].litrun = litrun; litrun = 0;
                    seqs[nseq].len = choice_len[i];
                    seqs[nseq].off = choice_off[i];
                    llf[257 + LEN2SYM[choice_len[i]]]++;
                    off_f[off2sym(choice_off[i])]++;
                    nseq++;
                    i += choice_len[i];
                }
            }
            if (litrun || nseq == 0) {
                seqs[nseq].litrun = litrun;
                seqs[nseq].len = 0; seqs[nseq].off = 0;
                nseq++;
            }
            if (pass < npass - 1) {
                llf[256]++;
                if (pm_lengths(llf, NUM_LITLEN, MAX_LL_LEN, llc)
                        || pm_lengths(off_f, NUM_OFFSET, MAX_OF_LEN, ofc)) {
                    w.error = ERR_BADDATA;
                    break;
                }
                /* unused symbols keep a moderate cost so the DP
                 * can adopt them when they would pay off — the harsh
                 * +2 penalty froze the symbol set once a pass dropped
                 * one (measured with the warm start: +0.12% L10,
                 * +0.19% L11, +0.12% L12 together with the full-window
                 * hash3 reach) */
                for (int s = 0; s < NUM_LITLEN; s++)
                    if (!llc[s]) llc[s] = 11;
                for (int s = 0; s < NUM_OFFSET; s++)
                    if (!ofc[s]) ofc[s] = 11;
            }
        }
        int final = (flush == 2 || flush == 3) && (bend == n);
        if (!w.error)
            write_block(&w, buf, bstart, bend, seqs, nseq, final, NULL);
        if (w.overflow || w.error) break;
        bstart = bend;
    }
    free(cands); free(ncand); free(choice_len); free(choice_off);
    free(cost); free(seqs); free(bt.child);
    if (w.error) return w.error;
    if (w.overflow) return ERR_SPACE;

    if (total_len == hist_len && (flush == 2 || flush == 3)) {
        bw_put(&w, 1, 3);
        bw_align(&w);
        bw_put(&w, 0, 16);
        bw_put(&w, 0xFFFF, 16);
    }
    if (flush == 1) {
        bw_put(&w, 0, 3);
        bw_align(&w);
        bw_put(&w, 0, 16);
        bw_put(&w, 0xFFFF, 16);
    }
    if (flush == 0 || flush == 3) return bw_finish_bits(&w);
    return bw_finish(&w);
}

/* deflate_c: buf holds history (hist_len bytes) + payload.
 * flush: 1 = SYNC (trailing empty stored block, byte aligned), 2 = FINISH.
 * Returns compressed size or negative error. */
int64_t deflate_c(const uint8_t *buf, int64_t hist_len, int64_t total_len,
                  int level, int flush, uint8_t *out, int64_t out_cap,
                  int32_t *work /* HASH_SIZE + total_len int32 */) {
    /* flush encodes mode | (bit_phase << 4): modes 0 = NONE (emit
     * complete blocks, no alignment, return BIT length), 1 = SYNC,
     * 2 = FINISH, 3 = FINISH-bits. bit_phase (0..7) is the stream's
     * current mid-byte position from a prior NONE call: the writer
     * starts there so stored-block alignment and SYNC padding stay
     * correct relative to the REAL stream, and the caller ORs the
     * first output byte into its pending partial byte. */
    int phase = (flush >> 4) & 7;
    flush &= 15;
    if (level >= 10 && level <= 12) {
        init_tables();
        if (hist_len > total_len) return ERR_BADDATA;
        return deflate_optimal(buf, hist_len, total_len, level,
                               flush | (phase << 4), out, out_cap, work);
    }
    init_tables();
    BitW w;
    bw_init(&w, out, out_cap);
    w.n = phase;
    int64_t n = total_len;
    if (level < 1 || level > 9) return ERR_BADDATA;
    if (hist_len > total_len) return ERR_BADDATA;

    if (total_len > hist_len) {
        const int *lp = LEVEL_PARAMS[level];
        MF mf;
        int hb = hash_bits_for(n);
        /* speed tiers: a 32K-entry head table (128 KB) halves the
         * random-load misses of the 64K one; measured ratio-identical
         * at every level <= 6 on the silesia-like corpus (+11% L1,
         * +4% L6), while the deep tiers 7-9 keep the full table */
        if (level <= 6 && hb > 15) hb = 15;
        mf.buf = buf; mf.n = n;
        mf.head = work;
        mf.head3 = work + (1 << hb);
        mf.prev16 = (uint16_t *)(work + 2 * HASH_SIZE);
        mf.hshift = 32 - hb;
        mf.ht = lp[0] == 2;
        mf.depth = lp[1]; mf.nice = lp[2]; mf.lazy = lp[0] == 1;
        mf.lazy2 = lp[3];
        mf.good = lp[4];
        mf.maxlazy = lp[5];
        mf.h3 = 0;   /* 3-byte matches only pay off under the DP tiers'
                      * cost model; greedily taken they disrupt longer
                      * matches (measured: ratio AND speed improve) */
        memset(work, -1, (size_t)(mf.ht ? 8 : 4) << hb);
        /* (measured: a BT matchfinder here LOSES to chains — the lazy
         * loop probes every position and pays full tree descents for
         * match-body inserts; chains insert in 3 ops. BT stays the DP
         * tiers' finder, where per-position find_all amortizes it.) */
        if (mf.ht)
            for (int64_t i = 0; i < hist_len; i++) ht_insert(&mf, i);
        else
            for (int64_t i = 0; i < hist_len; i++) mf_insert(&mf, i);

        static __thread Seq seqs[SOFT_BLOCK / 3 + 16];

        int64_t bstart = hist_len;
        while (bstart < n) {
            int64_t bend = bstart + SOFT_BLOCK < n ? bstart + SOFT_BLOCK : n;
            int nseq = 0;
    
            uint32_t litrun = 0;
            int64_t i = bstart;
            uint32_t held_len = 0, held_off = 0;
            /* literal-run skip-ahead (speed tiers): after a run of
             * probe misses, probe progressively sparser positions —
             * near-incompressible stretches stop paying a full hash +
             * chain walk per byte (the reference's HT-tier batched
             * skip_positions, reference src/compress/matchfinder.rs:
             * 1059-1106, re-expressed for hash chains) */
            int64_t misses = 0, next_probe = 0;
            Split sp;
            split_reset(&sp);
            while (i < bend) {
                if (sp.rec_total >= SPLIT_CHECK_EVERY && held_len == 0) {
                    if (split_check(&sp) && i - bstart >= SPLIT_MIN_BLOCK) {
                        bend = i;    /* distribution drifted: end block */
                        break;
                    }
                }
                uint32_t maxl = (uint32_t)(n - i);
                if (maxl > MAX_MATCH) maxl = MAX_MATCH;
                /* keep matches inside the block for clean block splits */
                if ((uint32_t)(bend - i) < maxl) maxl = (uint32_t)(bend - i);
                uint32_t off = 0;
                uint32_t len = 0;
                /* one hash per position: insertion returns the prior
                 * chain head, which is exactly where the probe walks.
                 * Greedy speed tiers skip BOTH the probe and the
                 * insert inside a miss run (the reference HT tier's
                 * batched skip_positions, reference
                 * src/compress/matchfinder.rs:1059-1106): on
                 * near-incompressible data the hash+store per byte is
                 * the dominant cost, and a 2-deep chain barely
                 * notices the missing links. */
                int do_probe = (i >= next_probe);
                int can_index = (i + MIN_MATCH + 1 <= n);
                int32_t j0 = -1;
                if (!mf.ht && can_index && (do_probe || mf.depth > 8))
                    j0 = mf_insert_get(&mf, i,
                                       hash4(buf + i, mf.hshift));
                if (do_probe) {
                    /* zlib's good_match rule: once the held match is
                     * already good, probe the next position shallowly */
                    int d = (mf.good && held_len >= (uint32_t)mf.good)
                        ? (mf.depth >> 2) : mf.depth;
                    if (can_index
                        && !(mf.maxlazy
                             && held_len >= (uint32_t)mf.maxlazy)) {
                        if (mf.ht)
                            len = ht_probe_insert(&mf, i, maxl, &off);
                        else
                            len = mf_walk(&mf, i, j0, maxl, &off, d);
                    }
                    /* miss-run skip-ahead. Greedy tiers ramp quickly;
                     * lazy tiers need a long warmup (128 misses, never
                     * reached on plain text) and a small stride, but
                     * deep inside incompressible stretches (sao/xray-
                     * class data) the hash+store per byte is ~all the
                     * cost and skipping it nearly doubles throughput
                     * at unchanged ratio (measured: sao +95%, xray
                     * +38%, text members +-1%). */
                    if (len >= 3) {
                        misses = 0;
                    } else if (held_len == 0) {
                        misses++;
                        if (!mf.lazy) {
                            if (misses >= 64) {
                                int64_t step = misses >> 6;
                                if (step > 7) step = 7;
                                next_probe = i + 1 + step;
                            }
                        } else if (misses >= 128) {
                            int64_t step = (misses - 96) >> 5;
                            if (step > 3) step = 3;
                            next_probe = i + 1 + step;
                        }
                    }
                }
                if (mf.lazy && held_len >= 3) {
                    /* previous position holds a match; compare */
                    int better = len > held_len ||
                        (mf.lazy2 && len == held_len && off && off < held_off);
                    if (better && held_len < (uint32_t)mf.nice) {
                        litrun++;
                        split_obs_lit(&sp, buf[i - 1]);
                        held_len = len; held_off = off;
                        i++;
                        continue;
                    }
                    /* commit held match at i-1 */
                    seqs[nseq].litrun = litrun; litrun = 0;
                    seqs[nseq].len = held_len;
                    seqs[nseq].off = held_off;
                    split_obs_match(&sp, held_len, held_off);
                    nseq++;
                    int64_t stop = i - 1 + held_len;
                    /* long matches insert sparsely: positions inside a
                     * long repeat add little chain value but cost a
                     * hash+store each (the reference HT-tier's batched
                     * skip, src/compress/matchfinder.rs:1059-1106) */
                    int64_t step = held_len >= 96 ? 4
                        : (held_len >= 24 ? 2 : 1);
                    if (mf.ht)
                        for (int64_t q = i + 1; q < stop; q += step)
                            ht_insert(&mf, q);
                    else
                        for (int64_t q = i + 1; q < stop; q += step)
                            mf_insert(&mf, q);
                    i = stop;
                    held_len = 0;
                    continue;
                }
                if (len >= 3) {
                    if (mf.lazy && len < (uint32_t)mf.nice) {
                        held_len = len; held_off = off;
                        i++;
                        continue;
                    }
                    seqs[nseq].litrun = litrun; litrun = 0;
                    seqs[nseq].len = len;
                    seqs[nseq].off = off;
                    split_obs_match(&sp, len, off);
                    nseq++;
                    int64_t stop = i + len;
                    int64_t step = len >= 96 ? 4
                        : (len >= 24 ? 2 : 1);
                    if (mf.ht)
                        for (int64_t q = i + 1; q < stop; q += step)
                            ht_insert(&mf, q);
                    else
                        for (int64_t q = i + 1; q < stop; q += step)
                            mf_insert(&mf, q);
                    i = stop;
                } else {
                    litrun++;
                    split_obs_lit(&sp, buf[i]);
                    i++;
                }
            }
            if (held_len >= 3) {
                /* held match extends to block end */
                seqs[nseq].litrun = litrun; litrun = 0;
                seqs[nseq].len = held_len;
                seqs[nseq].off = held_off;
                nseq++;
            }
            if (litrun || nseq == 0) {
                seqs[nseq].litrun = litrun;
                seqs[nseq].len = 0; seqs[nseq].off = 0;
                nseq++;
            }
            int final = (flush == 2 || flush == 3) && (bend == n);
            write_block(&w, buf, bstart, bend, seqs, nseq, final, NULL);
            if (w.error) return w.error;
            if (w.overflow) return ERR_SPACE;
            bstart = bend;
        }
    } else if (flush == 2 || flush == 3) {
        /* empty final stored block */
        bw_put(&w, 1, 3);
        bw_align(&w);
        bw_put(&w, 0, 16);
        bw_put(&w, 0xFFFF, 16);
    }

    if (flush == 1) {
        /* SYNC: empty stored block, leaves the stream byte-aligned */
        bw_put(&w, 0, 3);
        bw_align(&w);
        bw_put(&w, 0, 16);
        bw_put(&w, 0xFFFF, 16);
    }
    /* FlushMode::None (0) / bit-exact FINISH (3): no byte alignment —
     * return the BIT length; the caller carries the trailing partial
     * byte across calls (reference src/compress/mod.rs:424-429). */
    if (flush == 0 || flush == 3) return bw_finish_bits(&w);
    return bw_finish(&w);
}

/* ------------------------------------------------------------------ */
/* decoder                                                             */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *in, *end;
    uint64_t buf;
    int n;
} BitR;

static inline void br_refill(BitR *r) {
    /* branchless whole-word refill: load 8 bytes, advance by the bytes
     * actually absorbed, claim n in 56..63 (the libdeflate-style refill
     * the reference's decoder also uses, re-derived) */
    if (r->end - r->in >= 8) {
        uint64_t w;
        memcpy(&w, r->in, 8);
        r->buf |= w << r->n;
        r->in += (63 - r->n) >> 3;
        r->n |= 56;
        return;
    }
    while (r->n <= 56 && r->in < r->end) {
        r->buf |= (uint64_t)(*r->in++) << r->n;
        r->n += 8;
    }
}

static inline uint32_t br_bits(BitR *r, int nb) {
    return (uint32_t)(r->buf & ((1u << nb) - 1));
}

static inline void br_consume(BitR *r, int nb) {
    r->buf >>= nb;
    r->n -= nb;
}

/* flat decode table: entry = (sym << 4) | len; 0 invalid.
 * Rejects over-subscribed AND incomplete codes (zlib strictness for the
 * precode; the single-code exception applies only to the main tables,
 * see build_table2). */
static int build_table(const uint8_t *lens, int nsym, int maxlen,
                       int32_t *table) {
    int counts[16] = {0};
    for (int i = 0; i < nsym; i++) counts[lens[i]]++;
    counts[0] = 0;
    int64_t used = 0;
    for (int l = 1; l <= maxlen; l++) used += (int64_t)counts[l] << (maxlen - l);
    if (used != (1 << maxlen)) return ERR_BADDATA;
    memset(table, 0, sizeof(int32_t) << maxlen);
    int next[17]; int code = 0;
    for (int l = 1; l <= maxlen; l++) { code = (code + counts[l - 1]) << 1; next[l] = code; }
    for (int sym = 0; sym < nsym; sym++) {
        int l = lens[sym];
        if (!l) continue;
        int c = next[l]++;
        int rev = 0;
        for (int b = 0; b < l; b++) { rev = (rev << 1) | (c & 1); c >>= 1; }
        int32_t entry = (sym << 4) | l;
        int step = 1 << l;
        for (int idx = rev; idx < (1 << maxlen); idx += step) table[idx] = entry;
    }
    return 0;
}

/* two-level decode table (cache-resident root + subtables, the scheme of
 * the reference's build_decode_table, reference src/decompress/
 * mod.rs:1324-1495, re-derived). Entries are fully pre-computed so the
 * hot loop needs no secondary array loads or range checks:
 *   bits 0..4   codeword length to consume (0 = invalid entry)
 *   bits 5..7   type: 0 literal, 1 length/offset (payload = base,
 *               extra = extra-bit count), 2 end-of-block, 3 subtable
 *               pointer (payload = subtable base, extra = subtable
 *               bits), 4 two packed literals (payload = b1 | b2 << 8,
 *               extra = first codeword's length)
 *   bits 8..15  extra-bit count / subtable bits / first-code length
 *   bits 16..31 payload
 * Total size stays within 1 << 15 int32 for any valid code. */
#define E_TYPE(e) (((e) >> 5) & 7)
#define E_LEN(e) ((e) & 31)
#define E_EXTRA(e) (((e) >> 8) & 255)
#define E_PAY(e) ((uint32_t)(e) >> 16)
#define T_LIT 0
#define T_BASE 1
#define T_EOB 2
#define T_SUB 3
#define T_LIT2 4
/* invalid/unreachable slots: distinct type so the burst loop needs no
 * per-literal len!=0 check (E_LEN stays 0, so the checked loops' !l
 * tests keep catching it too) */
#define T_BAD 5
#define BAD_ENTRY ((int32_t)(T_BAD << 5))

static int32_t sym_entry(int sym, int is_offset) {
    /* returns -1 for symbols with no valid decode (286/287, offsets
     * 30/31): their table entries stay 0 and error only if referenced */
    if (is_offset) {
        if (sym > 29) return -1;
        return ((int32_t)OFF_BASE[sym] << 16)
            | ((int32_t)OFF_EXTRA[sym] << 8) | (T_BASE << 5);
    }
    if (sym < 256) return (sym << 16) | (T_LIT << 5);
    if (sym == 256) return T_EOB << 5;
    if (sym > 285) return -1;
    return ((int32_t)LEN_BASE[sym - 257] << 16)
        | ((int32_t)LEN_EXTRA[sym - 257] << 8) | (T_BASE << 5);
}

static int build_table2(const uint8_t *lens, int nsym, int root_bits,
                        int32_t *table, int is_offset, int pack_ok) {
    int counts[16] = {0};
    int maxlen = 0;
    for (int i = 0; i < nsym; i++) {
        counts[lens[i]]++;
        if (lens[i] > maxlen) maxlen = lens[i];
    }
    counts[0] = 0;
    if (maxlen == 0) {
        for (int i = 0; i < (1 << root_bits); i++) table[i] = BAD_ENTRY;
        return 0;
    }
    int64_t used = 0;
    for (int l = 1; l <= 15; l++) used += (int64_t)counts[l] << (15 - l);
    if (used > (1 << 15)) return ERR_BADDATA;
    /* incomplete codes rejected, except the RFC 1951 single-code case
     * (one code of one bit) that zlib and the reference accept
     * (reference src/decompress/mod.rs build_decode_table strictness) */
    if (used < (1 << 15) && maxlen != 1) return ERR_BADDATA;
    int root_size = 1 << root_bits;
    for (int i = 0; i < root_size; i++) table[i] = BAD_ENTRY;
    /* counting-sort symbols by code length, then walk codewords in
     * canonical order keeping the BIT-REVERSED codeword incrementally
     * (reversed-domain +1 = flip from the top bit down) — no O(len)
     * reversal per symbol (the reference builds tables the same way,
     * reference src/decompress/mod.rs:1324-1495) */
    int offs[17];
    offs[1] = 0;
    for (int l = 1; l < 16; l++) offs[l + 1] = offs[l] + counts[l];
    static __thread uint16_t sorted[NUM_LITLEN];
    for (int sym = 0; sym < nsym; sym++)
        if (lens[sym]) sorted[offs[lens[sym]]++] = (uint16_t)sym;
    int nsorted = offs[15];
    /* pre-pass: per-root-prefix max subtable bits for long codes —
     * same canonical walk with the incrementally-maintained reversed
     * codeword (a length increase appends a zero at the TOP of the
     * reversed code, so the value carries over unchanged) */
    static __thread uint8_t submax[1 << 12];
    memset(submax, 0, (size_t)root_size);
    {
        int rev = 0, cl = 0;
        for (int k = 0; k < nsorted; k++) {
            int l = lens[sorted[k]];
            if (l != cl) cl = l;
            if (l > root_bits) {
                int prefix = rev & (root_size - 1);
                if (l - root_bits > submax[prefix])
                    submax[prefix] = (uint8_t)(l - root_bits);
            }
            int bit = 1 << (cl - 1);
            while (rev & bit) { rev ^= bit; bit >>= 1; }
            rev |= bit;
            if (!bit) break;
        }
    }
    int alloc = root_size;
    {
    int rev = 0, cl = 0;
    for (int k = 0; k < nsorted; k++) {
        int sym = sorted[k];
        int l = lens[sym];
        if (l != cl) cl = l;   /* reversed code value carries over */
        int32_t base_entry = sym_entry(sym, is_offset);
        int advance_done = 0;
        (void)advance_done;
        if (l <= root_bits) {
            int32_t entry = base_entry >= 0 ? (base_entry | l) : BAD_ENTRY;
            int step = 1 << l;
            for (int idx = rev; idx < root_size; idx += step)
                table[idx] = entry;
        } else {
            int prefix = rev & (root_size - 1);
            int sub_bits = submax[prefix];
            int32_t re = table[prefix];
            int sub_base;
            if (E_TYPE(re) != T_SUB) {
                sub_base = alloc;
                alloc += 1 << sub_bits;
                if (alloc > (1 << 15)) return ERR_BADDATA;
                for (int i = 0; i < (1 << sub_bits); i++)
                    table[sub_base + i] = BAD_ENTRY;
                table[prefix] = ((int32_t)sub_base << 16)
                    | (sub_bits << 8) | (T_SUB << 5);
            } else {
                sub_base = (int)E_PAY(re);
            }
            int hi = rev >> root_bits;
            int step = 1 << (l - root_bits);
            int32_t entry = base_entry >= 0 ? (base_entry | l) : BAD_ENTRY;
            for (int idx = hi; idx < (1 << sub_bits); idx += step)
                table[sub_base + idx] = entry;
        }
        /* reversed increment at length cl */
        {
            int bit = 1 << (cl - 1);
            while (rev & bit) { rev ^= bit; bit >>= 1; }
            rev |= bit;
            if (!bit && k + 1 < nsorted) return ERR_BADDATA;
        }
    }
    }
    if (!is_offset && pack_ok) {
        /* double-literal packing: when a root entry is a literal and
         * the following codeword is a literal that also fits in the
         * root width, fuse both into one lookup (descending scan so the
         * second entry read is always an original one). Skipped when no
         * literal pair can fit the root width, and for small outputs
         * where the 2^root-entry pass outweighs the decode win. */
        int min_lit = 16;
        for (int sym2 = 0; sym2 < 256 && sym2 < nsym; sym2++)
            if (lens[sym2] && lens[sym2] < min_lit) min_lit = lens[sym2];
        if (2 * min_lit > root_bits) return 0;
        for (int idx = root_size - 1; idx >= 0; idx--) {
            int32_t e1 = table[idx];
            if (E_TYPE(e1) != T_LIT) continue;
            int l1 = E_LEN(e1);
            if (l1 >= root_bits) continue;
            int32_t e2 = table[idx >> l1];
            int l2 = E_LEN(e2);
            if (E_TYPE(e2) != T_LIT || !l2 || l1 + l2 > root_bits)
                continue;
            table[idx] = (int32_t)((E_PAY(e1) & 0xFF)
                                   | ((E_PAY(e2) & 0xFF) << 8)) << 16
                | (l1 << 8) | (T_LIT2 << 5) | (l1 + l2);
        }
    }
    return 0;
}

/* litlen root width. 11 bits (8 KiB root) measured best: a 12-bit
 * root packs slightly more double-literal pairs but its per-block
 * build cost loses more on multi-block streams than the pairs gain
 * (xml -29%, samba -11%, sao +-0). */
#define LL_ROOT 11
#define LL_RMASK ((1u << LL_ROOT) - 1)

/* returns output size or negative error; *consumed = input bytes used */
int64_t inflate_c(const uint8_t *in, int64_t in_len, uint8_t *out,
                  int64_t out_cap, int64_t *consumed) {
    init_tables();
    BitR r = {in, in + in_len, 0, 0};
    uint8_t *op = out, *oend = out + out_cap;
    static __thread int32_t ll_dyn[1 << 15];
    static __thread int32_t of_dyn[1 << 15];
    static __thread int32_t ll_static[1 << 15];
    static __thread int32_t of_static[1 << 12];
    static __thread int static_ready = 0;
    static __thread int static_packed = 0;
    int32_t *ll_table = ll_dyn, *of_table = of_dyn;
    int ll_bits = 0, of_bits = 0;

    for (;;) {
        br_refill(&r);
        if (r.n < 3) return ERR_SHORT;
        uint32_t hdr = br_bits(&r, 3);
        br_consume(&r, 3);
        int final = hdr & 1;
        int btype = hdr >> 1;
        if (btype == 0) {
            /* stored */
            br_consume(&r, r.n & 7);
            br_refill(&r);
            if (r.n < 32) return ERR_SHORT;
            uint32_t len = br_bits(&r, 16); br_consume(&r, 16);
            uint32_t nlen = br_bits(&r, 16); br_consume(&r, 16);
            if (len != (~nlen & 0xFFFF)) return ERR_BADDATA;
            /* bytes still in bitbuf first */
            while (len && r.n >= 8) {
                if (op >= oend) return ERR_SPACE;
                *op++ = (uint8_t)br_bits(&r, 8);
                br_consume(&r, 8);
                len--;
            }
            if ((int64_t)len > r.end - r.in) return ERR_SHORT;
            if (op + len > oend) return ERR_SPACE;
            memcpy(op, r.in, len);
            op += len;
            if (len) {
                /* r.in jumps: bits above n in buf (whole-word refill
                 * look-ahead) no longer mirror the bytes at r.in — drop
                 * them (the drain loop left n == 0 when len > 0) */
                r.in += len;
                r.buf = 0;
                r.n = 0;
            }
        } else if (btype == 1 || btype == 2) {
            uint8_t dll[NUM_LITLEN], dof[NUM_OFFSET];
            if (btype == 1) {
                static_lens(dll, dof);
                ll_bits = 9; of_bits = 5;
            } else {
                br_refill(&r);
                if (r.n < 14) return ERR_SHORT;
                int num_ll = (int)br_bits(&r, 5) + 257; br_consume(&r, 5);
                int num_of = (int)br_bits(&r, 5) + 1; br_consume(&r, 5);
                int ne = (int)br_bits(&r, 4) + 4; br_consume(&r, 4);
                if (num_ll > 286 || num_of > 30) return ERR_BADDATA;
                uint8_t plens[NUM_PRECODE] = {0};
                for (int k = 0; k < ne; k++) {
                    br_refill(&r);
                    if (r.n < 3) return ERR_SHORT;
                    plens[PRE_PERM[k]] = (uint8_t)br_bits(&r, 3);
                    br_consume(&r, 3);
                }
                int32_t ptab[1 << 7];
                if (build_table(plens, NUM_PRECODE, 7, ptab)) return ERR_BADDATA;
                uint8_t all[NUM_LITLEN + NUM_OFFSET];
                int tot = num_ll + num_of, i = 0;
                while (i < tot) {
                    br_refill(&r);
                    int32_t e = ptab[br_bits(&r, 7)];
                    int l = e & 0xF;
                    if (!l || l > r.n) return l ? ERR_SHORT : ERR_BADDATA;
                    br_consume(&r, l);
                    int sym = e >> 4;
                    if (sym <= 15) {
                        all[i++] = (uint8_t)sym;
                    } else if (sym == 16) {
                        if (i == 0) return ERR_BADDATA;
                        br_refill(&r);
                        if (r.n < 2) return ERR_SHORT;
                        int rep = 3 + (int)br_bits(&r, 2); br_consume(&r, 2);
                        if (i + rep > tot) return ERR_BADDATA;
                        for (int q = 0; q < rep; q++) { all[i] = all[i - 1]; i++; }
                    } else if (sym == 17) {
                        br_refill(&r);
                        if (r.n < 3) return ERR_SHORT;
                        int rep = 3 + (int)br_bits(&r, 3); br_consume(&r, 3);
                        if (i + rep > tot) return ERR_BADDATA;
                        while (rep--) all[i++] = 0;
                    } else {
                        br_refill(&r);
                        if (r.n < 7) return ERR_SHORT;
                        int rep = 11 + (int)br_bits(&r, 7); br_consume(&r, 7);
                        if (i + rep > tot) return ERR_BADDATA;
                        while (rep--) all[i++] = 0;
                    }
                }
                memset(dll, 0, sizeof dll);
                memset(dof, 0, sizeof dof);
                memcpy(dll, all, (size_t)num_ll);
                memcpy(dof, all + num_ll, (size_t)num_of);
                if (dll[256] == 0) return ERR_BADDATA;
                ll_bits = 0; of_bits = 0;
                for (int q = 0; q < NUM_LITLEN; q++)
                    if (dll[q] > ll_bits) ll_bits = dll[q];
                for (int q = 0; q < NUM_OFFSET; q++)
                    if (dof[q] > of_bits) of_bits = dof[q];
                if (!of_bits) of_bits = 1;
            }
            int pack_ok = (oend - op) > 16384;
            if (btype == 1) {
                /* static tables: cached after first build (the
                 * reference's OnceLock static-table cache, reference
                 * src/decompress/mod.rs:68-75) */
                if (!static_ready || static_packed != pack_ok) {
                    if (build_table2(dll, NUM_LITLEN, LL_ROOT, ll_static, 0,
                                     pack_ok)
                            || build_table2(dof, NUM_OFFSET, 8, of_static,
                                            1, 0))
                        return ERR_BADDATA;
                    static_ready = 1;
                    static_packed = pack_ok;
                }
                ll_table = ll_static;
                of_table = of_static;
            } else {
                ll_table = ll_dyn;
                of_table = of_dyn;
                if (build_table2(dll, NUM_LITLEN, LL_ROOT, ll_table, 0, pack_ok))
                    return ERR_BADDATA;
                if (build_table2(dof, NUM_OFFSET, 8, of_table, 1, 0))
                    return ERR_BADDATA;
            }
            /* fast loop: with >=400 output and >=16 input bytes of slack,
             * one refill covers a whole literal burst or a full match
             * (<=48 bits incl. extras) with no intermediate checks —
             * the analog of the reference's unchecked fast loop
             * (reference src/decompress/mod.rs:628-770) */
            int eob = 0;
            /* margin: <=98 burst literals + 258-byte match + 31 slop.
             * The next litlen entry is PRELOADED before each match copy
             * (libdeflate's fastloop preload, re-derived): the refill's
             * word load and the table load issue while the copy's
             * stores retire, so the loop-carried latency chain is the
             * copy alone, not copy -> refill -> table -> decode. */
            if (op + 400 <= oend && r.end - r.in >= 16) {
                br_refill(&r);   /* n in 56..63: covers a literal burst
                                  * or one full match (<=48 bits) */
                int32_t e = ll_table[(uint32_t)r.buf & LL_RMASK];
            while (op + 400 <= oend && r.end - r.in >= 16) {
                uint32_t len, off;
                /* THREE blind literal slots per refill, ONE predicted
                 * branch per slot (T_LIT (0) / T_LIT2 (4) share the
                 * (ty & 3) == 0 test; second byte stored blind and the
                 * pointer advanced by ty>>2, so pairs cost no extra
                 * branch — the 400-byte margin covers the over-store).
                 * Safe: the bottom refill guarantees n >= 56, each slot
                 * consumes <= 15 bits, and a refill only ADDS high bits
                 * so the preloaded entry stays valid across it. The old
                 * shape paid a second branch per literal (n < 15) plus
                 * an outer-loop bounce per refill — literal-heavy
                 * members (sao/xray) were the decode laggards. */
                {
                    int ty = E_TYPE(e);
                    if ((ty & 3) == 0) {
                        br_consume(&r, e & 31);
                        uint32_t pay = E_PAY(e);
                        op[0] = (uint8_t)pay;
                        op[1] = (uint8_t)(pay >> 8);
                        op += 1 + ((uint32_t)ty >> 2);
                        e = ll_table[(uint32_t)r.buf & LL_RMASK];
                        ty = E_TYPE(e);
                        if ((ty & 3) == 0) {
                            br_consume(&r, e & 31);
                            pay = E_PAY(e);
                            op[0] = (uint8_t)pay;
                            op[1] = (uint8_t)(pay >> 8);
                            op += 1 + ((uint32_t)ty >> 2);
                            e = ll_table[(uint32_t)r.buf & LL_RMASK];
                            ty = E_TYPE(e);
                            if ((ty & 3) == 0) {
                                br_consume(&r, e & 31);
                                pay = E_PAY(e);
                                op[0] = (uint8_t)pay;
                                op[1] = (uint8_t)(pay >> 8);
                                op += 1 + ((uint32_t)ty >> 2);
                                e = ll_table[(uint32_t)r.buf & LL_RMASK];
                                br_refill(&r);
                                continue;
                            }
                        }
                    }
                }
                /* non-literal: top up first — after three 15-bit slots
                 * n can be 11, below a subtable lookup's worst case
                 * (11 root + up to 4 sub bits beyond consumed) and
                 * below the fused match read (48 bits) */
                br_refill(&r);
                for (;;) {
                    int ty = E_TYPE(e);
                    if ((ty & 3) == 0) {
                        /* subtable entries can be literals: store one,
                         * re-establish the slot invariant (n >= 56 —
                         * three 15-bit slots need 45 and only 41 may
                         * remain here), and rejoin the slot loop */
                        br_consume(&r, e & 31);
                        uint32_t pay = E_PAY(e);
                        op[0] = (uint8_t)pay;
                        op[1] = (uint8_t)(pay >> 8);
                        op += 1 + ((uint32_t)ty >> 2);
                        e = ll_table[(uint32_t)r.buf & LL_RMASK];
                        br_refill(&r);
                        goto fast_continue;
                    }
                    if (ty == T_SUB) {
                        e = ll_table[E_PAY(e)
                            + ((uint32_t)(r.buf >> LL_ROOT)
                               & ((1u << E_EXTRA(e)) - 1))];
                        continue;
                    }
                    if (ty == T_EOB) {
                        br_consume(&r, E_LEN(e));
                        eob = 1;
                        goto fast_done;
                    }
                    if (ty == T_BAD) return ERR_BADDATA;
                    /* T_BASE: match length. The refill above covers the
                     * whole match worst case (15+5 length + 15+13
                     * offset = 48 <= 56 bits); code and extra bits
                     * are consumed in ONE shift each with the values
                     * extracted from the saved buffer (the
                     * saved-bitbuf trick of the reference's fast
                     * loop, reference src/decompress/mod.rs:628-770),
                     * halving the serial shift chain per match. */
                    {
                        uint64_t sv = r.buf;
                        int cl = E_LEN(e), ce = E_EXTRA(e);
                        br_consume(&r, cl + ce);
                        len = E_PAY(e)
                            + ((uint32_t)(sv >> cl)
                               & ((1u << ce) - 1));
                    }
                    break;
                }
                int32_t oe = of_table[(uint32_t)r.buf & 255];
                if (E_TYPE(oe) == T_SUB)
                    oe = of_table[E_PAY(oe)
                        + ((uint32_t)(r.buf >> 8)
                           & ((1u << E_EXTRA(oe)) - 1))];
                if (!E_LEN(oe)) return ERR_BADDATA;
                {
                    uint64_t sv = r.buf;
                    int ol = E_LEN(oe), oex = E_EXTRA(oe);
                    br_consume(&r, ol + oex);
                    off = E_PAY(oe)
                        + ((uint32_t)(sv >> ol)
                           & ((1u << oex) - 1));
                }
                if ((int64_t)off > op - out) return ERR_BADDATA;
                const uint8_t *src = op - off;
                uint8_t *dst = op;
                op += len;
                /* preload: next iteration's refill + root-table load
                 * overlap the copy below (the whole point of the
                 * restructured loop — see the margin comment above) */
                br_refill(&r);
                e = ll_table[(uint32_t)r.buf & LL_RMASK];
                if (off >= 32) {
                    /* the common case on binary data first. When the
                     * copy wraps (len > off) a contiguous 16B loop
                     * catches its own stores at an unaligned lag
                     * (store-forward stall: 0.6 GB/s at off 37) —
                     * double the pattern instead: each stage's copy is
                     * non-overlapping and avail stays a multiple of
                     * off, preserving the period. */
                    int64_t avail = off;
                    for (;;) {
                        int64_t rem = op - dst;
                        if (avail < rem) {
                            memcpy(dst, dst - avail, (size_t)avail);
                            dst += avail;
                            avail <<= 1;
                        } else {
                            const uint8_t *s2 = dst - avail;
                            do {
                                memcpy(dst, s2, 16);
                                dst += 16; s2 += 16;
                            } while (dst < op);
                            break;
                        }
                    }
                } else if (off == 1) {
                    memset(dst, *src, (size_t)(op - dst) + 15);
                } else if (off < 16) {
                    /* pattern broadcast (the reference's prepare_pattern,
                     * reference src/decompress/mod.rs:1258-1317, widened
                     * to 16-byte stores): build a 16-byte repeating
                     * pattern from bytes written BEFORE this match (no
                     * store-forwarding stalls) and stamp it with a
                     * stride of the largest multiple of off <= 16 */
                    int stride = (16 / (int)off) * (int)off;
#if defined(__SSSE3__)
                    /* one pshufb replaces the 16-step scalar k%off
                     * loop (the reference's per-offset shuffle kernels,
                     * reference src/decompress/x86.rs:2030-2190,
                     * collapsed into one mask-table lookup): measured
                     * 2.1-2.8x on offset-3/7/13 streams, +2% on text */
                    __m128i pv = _mm_shuffle_epi8(
                        _mm_loadu_si128((const __m128i *)src),
                        _mm_load_si128(
                            (const __m128i *)PAT_MASK16[off]));
                    do {
                        _mm_storeu_si128((__m128i *)dst, pv);
                        dst += stride;
                    } while (dst < op);
#else
                    uint8_t pat[16];
                    for (int k = 0; k < 16; k++) pat[k] = src[k % off];
                    do {
                        memcpy(dst, pat, 16);
                        dst += stride;
                    } while (dst < op);
#endif
                } else if (off < 32 && op - dst > (int64_t)off) {
                    /* 16 <= off < 32 with wrap-around: a 32-byte pattern
                     * (period off) stamped at stride off — the portable
                     * analog of the reference's alignr cycle kernels
                     * (reference src/decompress/x86.rs:133-139) that
                     * breaks the read-after-recent-write dependency */
                    uint8_t pat[48];
                    memcpy(pat, src, off);
                    memcpy(pat + off, src, 32 - off > 16 ? 16 : 32 - off);
                    do {
                        memcpy(dst, pat, 32);
                        dst += off;
                    } while (dst < op);
                } else {
                    /* margins allow 16-byte over-copy */
                    do {
                        memcpy(dst, src, 16);
                        dst += 16; src += 16;
                    } while (dst < op);
                }
fast_continue:;
            }
            }
fast_done:
            if (eob) {
                if (final) break; else continue;
            }
            for (;;) {
                br_refill(&r);
                int32_t e = ll_table[(uint32_t)r.buf & LL_RMASK];
                if (E_TYPE(e) == T_SUB)
                    e = ll_table[E_PAY(e)
                        + ((uint32_t)(r.buf >> LL_ROOT)
                           & ((1u << E_EXTRA(e)) - 1))];
                int l = E_LEN(e);
                int ty = E_TYPE(e);
                if (!l) return ERR_BADDATA;
                if (ty == T_LIT2) {
                    /* packed pair: fall back to single-symbol semantics
                     * when bits or output space cover only the first */
                    int l1 = E_EXTRA(e);
                    if (l1 > r.n) return ERR_SHORT;
                    if (op >= oend) return ERR_SPACE;
                    if (l > r.n || op + 2 > oend) {
                        br_consume(&r, l1);
                        *op++ = (uint8_t)(E_PAY(e) & 0xFF);
                        continue;
                    }
                    br_consume(&r, l);
                    uint32_t pay = E_PAY(e);
                    *op++ = (uint8_t)pay;
                    *op++ = (uint8_t)(pay >> 8);
                    continue;
                }
                if (l > r.n) return ERR_SHORT;
                br_consume(&r, l);
                if (ty == T_LIT) {
                    if (op >= oend) return ERR_SPACE;
                    *op++ = (uint8_t)E_PAY(e);
                    continue;
                }
                if (ty == T_EOB) break;
                uint32_t len = E_PAY(e);
                if (E_EXTRA(e)) {
                    br_refill(&r);
                    if (r.n < E_EXTRA(e)) return ERR_SHORT;
                    len += br_bits(&r, E_EXTRA(e));
                    br_consume(&r, E_EXTRA(e));
                }
                br_refill(&r);
                int32_t oe = of_table[(uint32_t)r.buf & 255];
                if (E_TYPE(oe) == T_SUB)
                    oe = of_table[E_PAY(oe)
                        + ((uint32_t)(r.buf >> 8)
                           & ((1u << E_EXTRA(oe)) - 1))];
                int ol = E_LEN(oe);
                if (!ol) return ERR_BADDATA;
                if (ol > r.n) return ERR_SHORT;
                br_consume(&r, ol);
                uint32_t off = E_PAY(oe);
                if (E_EXTRA(oe)) {
                    br_refill(&r);
                    if (r.n < E_EXTRA(oe)) return ERR_SHORT;
                    off += br_bits(&r, E_EXTRA(oe));
                    br_consume(&r, E_EXTRA(oe));
                }
                if ((int64_t)off > op - out) return ERR_BADDATA;
                if (op + len > oend) return ERR_SPACE;
                const uint8_t *src = op - off;
                if (off >= 8) {
                    uint8_t *dst = op;
                    op += len;
                    while (len >= 8) {
                        memcpy(dst, src, 8);
                        dst += 8; src += 8; len -= 8;
                    }
                    while (len--) *dst++ = *src++;
                } else {
                    uint8_t *dst = op;
                    op += len;
                    while (len--) *dst++ = *src++;
                }
            }
        } else {
            return ERR_BADDATA;
        }
        if (final) break;
    }
    if (consumed)
        *consumed = (r.in - in) - (r.n >> 3);
    return op - out;
}

/* ------------------------------------------------------------------ */
/* checksums                                                           */
/* ------------------------------------------------------------------ */
/* Tiered like the reference's per-ISA dispatch (reference src/crc32/
 * mod.rs:332-365, src/adler32/mod.rs:114-152), collapsed to one x86
 * SIMD tier each + a portable scalar tier, selected once at runtime.
 * The CRC folding constants are NOT copied: they are recomputed at
 * startup from first principles — fold-by-D-bytes needs
 * k_lo = rev33(x^(8D+32) mod P), k_hi = rev33(x^(8D-32) mod P)
 * (derived and verified against the raw-register identity
 * rawcrc(fold(V)) == rawcrc(V || D zero bytes); the scheme itself is
 * the public Intel PCLMULQDQ-CRC whitepaper construction). */

static uint32_t crc_tab[8][256];
static int crc_ready = 0;

static void crc_init(void) {
    if (crc_ready) return;
    for (int b = 0; b < 256; b++) {
        uint32_t c = (uint32_t)b;
        for (int k = 0; k < 8; k++)
            c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
        crc_tab[0][b] = c;
    }
    for (int t = 1; t < 8; t++)
        for (int b = 0; b < 256; b++)
            crc_tab[t][b] = (crc_tab[t - 1][b] >> 8)
                ^ crc_tab[0][crc_tab[t - 1][b] & 0xFF];
    crc_ready = 1;
}

/* raw register update (init 0 == raw reflected CRC; linear in data) */
__attribute__((noinline))
static uint32_t crc_raw_slice8(uint32_t crc, const uint8_t *p,
                               int64_t n) {
    while (n && ((uintptr_t)p & 7)) { crc = (crc >> 8) ^ crc_tab[0][(crc ^ *p++) & 0xFF]; n--; }
    while (n >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        w ^= crc;
        crc = crc_tab[7][w & 0xFF] ^ crc_tab[6][(w >> 8) & 0xFF]
            ^ crc_tab[5][(w >> 16) & 0xFF] ^ crc_tab[4][(w >> 24) & 0xFF]
            ^ crc_tab[3][(w >> 32) & 0xFF] ^ crc_tab[2][(w >> 40) & 0xFF]
            ^ crc_tab[1][(w >> 48) & 0xFF] ^ crc_tab[0][(w >> 56) & 0xFF];
        p += 8; n -= 8;
    }
    while (n--) crc = (crc >> 8) ^ crc_tab[0][(crc ^ *p++) & 0xFF];
    return crc;
}

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#include <cpuid.h>

/* x^n mod P via square-and-multiply on small (<2^33) polynomials */
static uint64_t poly_mod_p(unsigned __int128 a) {
    const unsigned __int128 P = 0x104C11DB7ull;
    while (a >> 32) {
        unsigned __int128 t = a >> 32;
        int hb = 32;
        while (t >> 1) { t >>= 1; hb++; }
        a ^= P << (hb - 32);
    }
    return (uint64_t)a;
}

static uint64_t poly_mulmod(uint64_t a, uint64_t b) {
    /* operands already reduced (< 2^33); product fits 66 bits */
    unsigned __int128 r = 0;
    for (int i = 0; i < 33; i++)
        if ((b >> i) & 1) r ^= (unsigned __int128)a << i;
    return poly_mod_p(r);
}

static uint64_t xpow_mod(uint64_t n) {
    uint64_t r = 1, base = 2;
    while (n) {
        if (n & 1) r = poly_mulmod(r, base);
        base = poly_mulmod(base, base);
        n >>= 1;
    }
    return r;
}

static uint64_t rev_bits(uint64_t v, int bits) {
    uint64_t r = 0;
    for (int i = 0; i < bits; i++)
        if ((v >> i) & 1) r |= 1ull << (bits - 1 - i);
    return r;
}

/* fold-by-D constants, computed once */
static uint64_t crc_k[4][2]; /* D = 64, 48, 32, 16 */
static int crc_simd_tier = -1; /* -1 unknown, 0 scalar, 1 pclmul */

static void crc_simd_init(void) {
    if (crc_simd_tier >= 0) return;
    unsigned eax, ebx, ecx, edx;
    int ok = 0;
    if (__get_cpuid(1, &eax, &ebx, &ecx, &edx))
        ok = (ecx & bit_PCLMUL) && (ecx & bit_SSE4_1);
    if (ok) {
        static const int ds[4] = {64, 48, 32, 16};
        for (int i = 0; i < 4; i++) {
            crc_k[i][0] = rev_bits(xpow_mod(8ull * ds[i] + 32), 33);
            crc_k[i][1] = rev_bits(xpow_mod(8ull * ds[i] - 32), 33);
        }
        crc_simd_tier = 1;
    } else {
        crc_simd_tier = 0;
    }
}

__attribute__((target("pclmul,sse4.1")))
static uint32_t crc_raw_pclmul(uint32_t crc, const uint8_t *p, int64_t n) {
    /* maintain: final = rawcrc(x0||x1||x2||x3 || remaining bytes) */
    const __m128i k64 = _mm_set_epi64x((long long)crc_k[0][1],
                                       (long long)crc_k[0][0]);
    const __m128i k48 = _mm_set_epi64x((long long)crc_k[1][1],
                                       (long long)crc_k[1][0]);
    const __m128i k32 = _mm_set_epi64x((long long)crc_k[2][1],
                                       (long long)crc_k[2][0]);
    const __m128i k16 = _mm_set_epi64x((long long)crc_k[3][1],
                                       (long long)crc_k[3][0]);
    __m128i x0 = _mm_loadu_si128((const __m128i *)p);
    __m128i x1 = _mm_loadu_si128((const __m128i *)(p + 16));
    __m128i x2 = _mm_loadu_si128((const __m128i *)(p + 32));
    __m128i x3 = _mm_loadu_si128((const __m128i *)(p + 48));
    x0 = _mm_xor_si128(x0, _mm_cvtsi32_si128((int)crc));
    p += 64; n -= 64;
    while (n >= 64) {
        x0 = _mm_xor_si128(
            _mm_xor_si128(_mm_clmulepi64_si128(x0, k64, 0x00),
                          _mm_clmulepi64_si128(x0, k64, 0x11)),
            _mm_loadu_si128((const __m128i *)p));
        x1 = _mm_xor_si128(
            _mm_xor_si128(_mm_clmulepi64_si128(x1, k64, 0x00),
                          _mm_clmulepi64_si128(x1, k64, 0x11)),
            _mm_loadu_si128((const __m128i *)(p + 16)));
        x2 = _mm_xor_si128(
            _mm_xor_si128(_mm_clmulepi64_si128(x2, k64, 0x00),
                          _mm_clmulepi64_si128(x2, k64, 0x11)),
            _mm_loadu_si128((const __m128i *)(p + 32)));
        x3 = _mm_xor_si128(
            _mm_xor_si128(_mm_clmulepi64_si128(x3, k64, 0x00),
                          _mm_clmulepi64_si128(x3, k64, 0x11)),
            _mm_loadu_si128((const __m128i *)(p + 48)));
        p += 64; n -= 64;
    }
    /* combine 4 lanes into one 128-bit register */
    __m128i y = _mm_xor_si128(
        _mm_xor_si128(
            _mm_xor_si128(_mm_clmulepi64_si128(x0, k48, 0x00),
                          _mm_clmulepi64_si128(x0, k48, 0x11)),
            _mm_xor_si128(_mm_clmulepi64_si128(x1, k32, 0x00),
                          _mm_clmulepi64_si128(x1, k32, 0x11))),
        _mm_xor_si128(
            _mm_xor_si128(_mm_clmulepi64_si128(x2, k16, 0x00),
                          _mm_clmulepi64_si128(x2, k16, 0x11)),
            x3));
    while (n >= 16) {
        y = _mm_xor_si128(
            _mm_xor_si128(_mm_clmulepi64_si128(y, k16, 0x00),
                          _mm_clmulepi64_si128(y, k16, 0x11)),
            _mm_loadu_si128((const __m128i *)p));
        p += 16; n -= 16;
    }
    uint8_t tailbuf[16] __attribute__((aligned(16)));
    _mm_store_si128((__m128i *)tailbuf, y);
    uint32_t r = crc_raw_slice8(0, tailbuf, 16);
    return crc_raw_slice8(r, p, n);
}
#endif /* x86 */

uint32_t crc32_c(uint32_t crc, const uint8_t *p, int64_t n) {
    crc_init();
    crc = ~crc;
#if defined(__x86_64__) || defined(__i386__)
    crc_simd_init();
    if (crc_simd_tier == 1 && n >= 128) {
        return ~crc_raw_pclmul(crc, p, n);
    }
#endif
    return ~crc_raw_slice8(crc, p, n);
}

#if defined(__x86_64__) || defined(__i386__)
static int adler_simd_tier = -1;

static void adler_simd_init(void) {
    if (adler_simd_tier >= 0) return;
    adler_simd_tier = __builtin_cpu_supports("avx2") ? 1 : 0;
#if defined(__x86_64__)
    if (__builtin_cpu_supports("avx512bw")
            && __builtin_cpu_supports("avx512vnni"))
        adler_simd_tier = 2;
#endif
}

#if defined(__x86_64__)
__attribute__((target("avx512bw,avx512vnni,avx512f")))
static uint32_t adler32_vnni(uint32_t adler, const uint8_t *p, int64_t n) {
    /* AVX-512 VNNI tier (the reference's top tier, reference
     * src/adler32/x86.rs:904+, own design): 64 bytes per iteration as
     * ONE vpdpbusd against descending weights for the in-block dot,
     * one vpsadbw for the byte sum, and the rolled s1 prefix in epi64
     * lanes. blk <= 5504 (NMAX rounded to 64) keeps every accumulator
     * exact. */
    static const uint8_t WB[64] = {
        64, 63, 62, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49,
        48, 47, 46, 45, 44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33,
        32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
        16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1};
    uint32_t s1 = adler & 0xFFFF, s2 = adler >> 16;
    const __m512i zero = _mm512_setzero_si512();
    const __m512i w64 = _mm512_loadu_si512((const void *)WB);
    /* first half of a 128-byte unit needs weights 128..65, but
     * vpdpbusd's second operand is SIGNED i8 (max 127): use 127..64
     * and add one extra byte-sum of the d0 stream (dot(d, 128..65) =
     * dot(d, 127..64) + sum(d)), which vs1a already accumulates */
    const __m512i w128 = _mm512_add_epi8(w64, _mm512_set1_epi8(63));
    while (n >= 128) {
        /* 128 B per iteration, two independent dpbusd streams;
         * 5504 = 43 * 128 keeps the NMAX bound and the unit size */
        int64_t blk = n > 5504 ? 5504 : (n & ~(int64_t)127);
        n -= blk;
        __m512i vs1a = zero, vs1b = zero, vroll = zero;
        __m512i vs2a = zero, vs2b = zero;
        for (int64_t i = 0; i < blk; i += 128) {
            __m512i d0 = _mm512_loadu_si512((const void *)(p + i));
            __m512i d1 = _mm512_loadu_si512((const void *)(p + i + 64));
            vroll = _mm512_add_epi64(
                vroll, _mm512_add_epi64(vs1a, vs1b));
            vs1a = _mm512_add_epi64(vs1a, _mm512_sad_epu8(d0, zero));
            vs1b = _mm512_add_epi64(vs1b, _mm512_sad_epu8(d1, zero));
            vs2a = _mm512_dpbusd_epi32(vs2a, d0, w128);
            vs2b = _mm512_dpbusd_epi32(vs2b, d1, w64);
        }
        uint64_t bsum_a = (uint64_t)_mm512_reduce_add_epi64(vs1a);
        uint64_t bsum = bsum_a
            + (uint64_t)_mm512_reduce_add_epi64(vs1b);
        uint64_t rsum = (uint64_t)_mm512_reduce_add_epi64(vroll);
        uint64_t wsum = (uint64_t)(uint32_t)_mm512_reduce_add_epi32(vs2a)
            + (uint64_t)(uint32_t)_mm512_reduce_add_epi32(vs2b);
        uint64_t s2w = (uint64_t)s2 + (uint64_t)s1 * (uint64_t)blk
            + 128ull * rsum + wsum + bsum_a;
        s1 = (uint32_t)(((uint64_t)s1 + bsum) % 65521);
        s2 = (uint32_t)(s2w % 65521);
        p += blk;
    }
    if (n >= 64) {
        __m512i d = _mm512_loadu_si512((const void *)p);
        uint64_t bsum = (uint64_t)_mm512_reduce_add_epi64(
            _mm512_sad_epu8(d, zero));
        uint64_t wsum = (uint64_t)(uint32_t)_mm512_reduce_add_epi32(
            _mm512_dpbusd_epi32(zero, d, w64));
        uint64_t s2w = (uint64_t)s2 + (uint64_t)s1 * 64ull + wsum;
        s1 = (uint32_t)(((uint64_t)s1 + bsum) % 65521);
        s2 = (uint32_t)(s2w % 65521);
        p += 64; n -= 64;
    }
    while (n--) { s1 += *p++; s2 += s1; }
    s1 %= 65521; s2 %= 65521;
    return (s2 << 16) | s1;
}
#endif

__attribute__((target("avx2")))
static uint32_t adler32_avx2(uint32_t adler, const uint8_t *p, int64_t n) {
    /* 64 bytes/iteration, two independent SAD/maddubs streams: per
     * 64-byte block s2 gains 64*s1_before + dot(b, [64..1]), tracked as
     * a once-per-block rolled prefix (x64 at reduction) plus two
     * weighted dots; s1 gains the two SAD byte sums. Halving the
     * serial vs1->vroll dependency per byte is worth ~1.5x on large
     * buffers. 5504 = NMAX rounded down to 64 keeps the 32-bit dot
     * lanes exact. */
    uint32_t s1 = adler & 0xFFFF, s2 = adler >> 16;
    const __m256i zero = _mm256_setzero_si256();
    const __m256i whi = _mm256_setr_epi8(
        64, 63, 62, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49,
        48, 47, 46, 45, 44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33);
    const __m256i wlo = _mm256_setr_epi8(
        32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
        16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1);
    const __m256i ones16 = _mm256_set1_epi16(1);
    while (n >= 64) {
        int64_t blk = n > 5504 ? 5504 : (n & ~(int64_t)63);
        n -= blk;
        __m256i vs1 = zero, vroll = zero, vs2a = zero, vs2b = zero;
        for (int64_t i = 0; i < blk; i += 64) {
            __m256i d0 = _mm256_loadu_si256((const __m256i *)(p + i));
            __m256i d1 = _mm256_loadu_si256(
                (const __m256i *)(p + i + 32));
            vroll = _mm256_add_epi64(vroll, vs1);
            vs1 = _mm256_add_epi64(
                vs1, _mm256_add_epi64(_mm256_sad_epu8(d0, zero),
                                      _mm256_sad_epu8(d1, zero)));
            vs2a = _mm256_add_epi32(
                vs2a, _mm256_madd_epi16(_mm256_maddubs_epi16(d0, whi),
                                        ones16));
            vs2b = _mm256_add_epi32(
                vs2b, _mm256_madd_epi16(_mm256_maddubs_epi16(d1, wlo),
                                        ones16));
        }
        uint64_t lanes1[4], roll[4];
        uint32_t lanes2[8], lanes3[8];
        _mm256_storeu_si256((__m256i *)lanes1, vs1);
        _mm256_storeu_si256((__m256i *)roll, vroll);
        _mm256_storeu_si256((__m256i *)lanes2, vs2a);
        _mm256_storeu_si256((__m256i *)lanes3, vs2b);
        uint64_t bsum = lanes1[0] + lanes1[1] + lanes1[2] + lanes1[3];
        uint64_t rsum = roll[0] + roll[1] + roll[2] + roll[3];
        uint64_t wsum = 0;
        for (int k = 0; k < 8; k++) wsum += lanes2[k] + lanes3[k];
        uint64_t s2w = (uint64_t)s2 + (uint64_t)s1 * (uint64_t)blk
            + 64ull * rsum + wsum;
        s1 = (uint32_t)(((uint64_t)s1 + bsum) % 65521);
        s2 = (uint32_t)(s2w % 65521);
        p += blk;
    }
    while (n--) { s1 += *p++; s2 += s1; }
    s1 %= 65521; s2 %= 65521;
    return (s2 << 16) | s1;
}
#endif /* x86 */

uint32_t adler32_c(uint32_t adler, const uint8_t *p, int64_t n) {
    /* zlib reduces non-canonical init values mod 65521 up front */
    adler = (adler & 0xFFFF) % 65521
        | (uint32_t)(((adler >> 16) % 65521) << 16);
#if defined(__x86_64__) || defined(__i386__)
    adler_simd_init();
#if defined(__x86_64__)
    if (adler_simd_tier == 2 && n >= 64)
        return adler32_vnni(adler, p, n);
#endif
    if (adler_simd_tier >= 1 && n >= 64)
        return adler32_avx2(adler, p, n);
#endif
    uint32_t s1 = adler & 0xFFFF, s2 = adler >> 16;
    while (n > 0) {
        int64_t chunk = n > 5552 ? 5552 : n;
        n -= chunk;
        while (chunk >= 16) {
            for (int k = 0; k < 16; k++) { s1 += p[k]; s2 += s1; }
            p += 16; chunk -= 16;
        }
        while (chunk--) { s1 += *p++; s2 += s1; }
        s1 %= 65521; s2 %= 65521;
    }
    return (s2 << 16) | s1;
}

/* ------------------------------------------------------------------ */
/* dynamic-Huffman table + header builder for the device encoder      */
/* ------------------------------------------------------------------ */

/* Per-block service for the device dynamic tier (ops/encode_dynamic.py):
 * the device computes symbol histograms; this turns them into
 * length-limited canonical code tables plus the serialized dynamic
 * block header (reference src/compress/mod.rs:1775-1883 is the analog).
 *
 * llf_in: 288 litlen freqs (EOB counted here), off_in: 30 offset freqs.
 * ll_out[288] / of_out[30]: code | len<<16 (codes bit-reversed for
 * LSB-first emission). hdr_out: bit-packed header from bit 0 including
 * the 3-bit block header (BFINAL | BTYPE=10). Returns total header bits
 * (> 0), or -1 on Huffman build failure / -2 on overflow. */
int64_t dyn_tables_c(const uint32_t *llf_in, const uint32_t *off_in,
                     int final, uint32_t *ll_out, uint32_t *of_out,
                     uint8_t *hdr_out, int64_t hdr_cap) {
    init_tables();  /* REV8 (canonical codes); this entry point does
                     * not pass through deflate_c's init */
    uint64_t llf[NUM_LITLEN] = {0}, off_f[NUM_OFFSET] = {0};
    for (int i = 0; i < NUM_LITLEN; i++) llf[i] = llf_in[i];
    for (int i = 0; i < 30; i++) off_f[i] = off_in[i];
    llf[256] += 1;  /* end-of-block */
    uint8_t dll[NUM_LITLEN], dof[NUM_OFFSET];
    if (pm_lengths(llf, NUM_LITLEN, MAX_LL_LEN, dll)
            || pm_lengths(off_f, 30, MAX_OF_LEN, dof))
        return -1;
    ensure_complete(dll, NUM_LITLEN);
    ensure_complete(dof, 30);
    int num_ll = NUM_LITLEN;
    while (num_ll > 257 && dll[num_ll - 1] == 0) num_ll--;
    int num_of = 30;
    while (num_of > 1 && dof[num_of - 1] == 0) num_of--;
    DynHdr hdr;
    if (build_dyn_header(dll, dof, num_ll, num_of, &hdr)) return -1;
    uint16_t ll_codes[NUM_LITLEN], of_codes[NUM_OFFSET];
    canonical_codes(dll, NUM_LITLEN, ll_codes);
    canonical_codes(dof, 30, of_codes);
    for (int i = 0; i < NUM_LITLEN; i++)
        ll_out[i] = (uint32_t)ll_codes[i] | ((uint32_t)dll[i] << 16);
    for (int i = 0; i < 30; i++)
        of_out[i] = (uint32_t)of_codes[i] | ((uint32_t)dof[i] << 16);
    BitW w;
    bw_init(&w, hdr_out, hdr_cap);
    bw_put(&w, (final ? 1 : 0) | 4, 3); /* BTYPE=10 */
    bw_put(&w, (uint32_t)(num_ll - 257), 5);
    bw_put(&w, (uint32_t)(num_of - 1), 5);
    bw_put(&w, (uint32_t)(hdr.num_explicit - 4), 4);
    for (int k = 0; k < hdr.num_explicit; k++)
        bw_put(&w, hdr.pre_lens[PRE_PERM[k]], 3);
    for (int k = 0; k < hdr.np; k++) {
        int s = hdr.psyms[k];
        bw_put(&w, hdr.pre_codes[s], hdr.pre_lens[s]);
        if (hdr.peb[k]) bw_put(&w, hdr.pev[k], hdr.peb[k]);
        bw_flushbytes(&w);
    }
    bw_flushbytes(&w);
    if (w.n > 0) {
        if (w.out >= w.end) return -2;
        *w.out++ = (uint8_t)w.buf;
    }
    if (w.overflow) return -2;
    return 3 + hdr.hdr_bits;
}

/* ------------------------------------------------------------------ */
/* Eager global init: the lazy ready-flag pattern above is not safe    */
/* once callers release the GIL (pool threads may observe the flag     */
/* store before the table/constant stores). Called once at load time   */
/* from PyInit__codec / the ctypes loader, while still single-threaded.*/
/* ------------------------------------------------------------------ */
void ldrsx_global_init(void) {
    init_tables();
    crc_init();
#if defined(__x86_64__) || defined(__i386__)
    crc_simd_init();
    adler_simd_init();
#endif
}

/* ------------------------------------------------------------------ */
/* LZ token resolver — pass 2 of the two-pass device decoder.          */
/* Token format: ops/tokens.py (kind in bits 29..30: 0 NOP, 1 literal  */
/* byte in 0..7, 2 match with len-3 in 0..7 and dist-1 in 8..22).      */
/* Runs at memcpy speed: the device pass-1 kernel already did all bit  */
/* and Huffman work. Returns output length, or -1 on an invalid token  */
/* (dist beyond start, output overflow).                               */
/* ------------------------------------------------------------------ */
int64_t resolve_tokens_c(const int32_t *toks, int64_t ntoks,
                         uint8_t *out, int64_t out_cap) {
    uint8_t *op = out, *oend = out + out_cap;
    /* fast region: 40 bytes of slack lets match copies run 16-wide
     * without per-byte bounds checks */
    uint8_t *osafe = out_cap > 300 ? oend - 300 : out;
    for (int64_t i = 0; i < ntoks; i++) {
        int32_t t = toks[i];
        uint32_t kind = ((uint32_t)t >> 29) & 3;
        if (kind == 0) continue;
        if (kind == 1) {
            if (op >= oend) return -1;
            *op++ = (uint8_t)t;
            continue;
        }
        if (kind != 2) return -1;
        int64_t len = (t & 0xFF) + 3;
        int64_t dist = ((t >> 8) & 0x7FFF) + 1;
        if (dist > op - out) return -1;
        if (op + len > oend) return -1;
        const uint8_t *src = op - dist;
        uint8_t *dst = op;
        op += len;
        if (op < osafe) {
            if (dist >= 16) {
                do {
                    memcpy(dst, src, 16);
                    dst += 16; src += 16;
                } while (dst < op);
            } else if (dist >= 8) {
                do {
                    memcpy(dst, src, 8);
                    dst += 8; src += 8;
                } while (dst < op);
            } else {
                /* small offset: stamp a 16-byte period-`dist` pattern,
                 * advancing by the largest multiple of dist <= 16 so
                 * every stamp stays phase-aligned */
                uint8_t pat[16];
                for (int k = 0; k < 16; k++) pat[k] = src[k % dist];
                int64_t adv = dist * (16 / dist);
                do {
                    memcpy(dst, pat, 16);
                    dst += adv;
                } while (dst < op);
            }
        } else {
            while (dst < op) *dst++ = *src++;
        }
    }
    return op - out;
}

/* ------------------------------------------------------------------ */
/* Resumable streaming decoder — native analog of the Python Inflater  */
/* (models/portable/inflate.py) for non-seekable readers: bit-level    */
/* state, per-symbol input suspend, mid-match output suspend, own      */
/* 32 KiB ring window so callers never re-present history. Mirrors the */
/* reference's resumable state machine (reference                      */
/* src/decompress/mod.rs:213-353) re-derived from the portable engine. */
/* Status: 0 done, 1 short input, 2 insufficient space, -1 bad data.   */
/* ------------------------------------------------------------------ */

#define ICX_BLKSTART 0
#define ICX_STORED 1
#define ICX_BODY 2
#define ICX_MATCH 3
#define ICX_DONE 4

typedef struct {
    uint64_t bitbuf;
    int32_t bitcnt;
    int32_t state;
    int32_t final_blk;
    int32_t stored_rem;
    int32_t match_len;
    int32_t match_dist;
    int64_t total_out;
    uint32_t wpos;            /* ring write position (mod 32768) */
    int32_t pad_;
    uint8_t window[1 << 15];
    int32_t ll_tab[1 << 15];
    int32_t of_tab[1 << 12];
} ICtx;

int64_t icx_size(void) { return (int64_t)sizeof(ICtx); }

void icx_init(void *p) {
    ICtx *c = (ICtx *)p;
    memset(c, 0, offsetof(ICtx, window));
}

int icx_finished(const void *p) {
    return ((const ICtx *)p)->state == ICX_DONE;
}

/* fold this step's output into the ring history in ONE bulk pass at
 * step exit (the previous design mirrored every byte into the ring as
 * it was written — a second store per output byte that capped the
 * whole streaming decoder at ~0.2 GB/s) */
static inline void icx_sync(ICtx *c, const uint8_t *out,
                            const uint8_t *op) {
    int64_t m = op - out;
    c->total_out += m;
    if (!m) return;
    int64_t take = m > 32768 ? 32768 : m;
    const uint8_t *sp = op - take;
    uint32_t w = (c->wpos + (uint32_t)(m - take)) & 32767;
    int64_t first = 32768 - w;
    if (first > take) first = take;
    memcpy(c->window + w, sp, (size_t)first);
    memcpy(c->window, sp + first, (size_t)(take - first));
    c->wpos = (uint32_t)((w + take) & 32767);
}

/* checked refill that never reads past `end`: one whole-word load when
 * 8 input bytes exist (the hot case — the burst refills every ~7
 * symbols and a byte loop here was measured to halve literal-heavy
 * throughput), byte loop at the stream tail */
static inline void icx_refill(BitR *r) {
    if (r->end - r->in >= 8) {
        uint64_t w;
        memcpy(&w, r->in, 8);
        r->buf |= w << r->n;
        r->in += (63 - r->n) >> 3;
        r->n |= 56;
        return;
    }
    while (r->n <= 56 && r->in < r->end) {
        r->buf |= (uint64_t)(*r->in++) << r->n;
        r->n += 8;
    }
}

int64_t icx_step(void *p, const uint8_t *in, int64_t in_len,
                 uint8_t *out, int64_t out_cap,
                 int64_t *in_used, int64_t *out_written) {
    ICtx *c = (ICtx *)p;
    BitR r = {in, in + in_len, c->bitbuf, c->bitcnt};
    uint8_t *op = out, *oend = out + out_cap;
    int64_t rc = 1;   /* default: short input */

#define ICX_SAVE_RET(code) do { \
        c->bitbuf = r.buf; c->bitcnt = r.n; \
        icx_sync(c, out, op); \
        *in_used = r.in - in; *out_written = op - out; \
        return (code); } while (0)
#define ICX_RESTORE_RET(code) do { \
        c->bitbuf = snap_buf; c->bitcnt = snap_n; \
        icx_sync(c, out, op); \
        *in_used = snap_in - in; *out_written = op - out; \
        return (code); } while (0)

    for (;;) {
        if (c->state == ICX_DONE) {
            /* give back whole bytes still in the bit buffer so the
             * consumed count lands exactly at the stream end */
            int back = r.n >> 3;
            c->bitbuf = r.buf & ((back < 8) ? ((1ull << (r.n & 7)) - 1)
                                            : ~0ull);
            c->bitcnt = r.n & 7;
            icx_sync(c, out, op);
            *in_used = (r.in - in) - back;
            *out_written = op - out;
            return 0;
        }
        if (c->state == ICX_MATCH) {
            int64_t dist = c->match_dist;
            for (;;) {
                int64_t nrem = c->match_len;
                if (!nrem) break;
                int64_t room = oend - op;
                if (room <= 0) ICX_SAVE_RET(2);
                int64_t nn = nrem < room ? nrem : room;
                int64_t back_here = op - out;
                if (dist <= back_here) {
                    /* source entirely inside this step's output:
                     * inflate_c-style copy (no ring involved) */
                    const uint8_t *sp = op - dist;
                    uint8_t *dst = op;
                    uint8_t *lim = op + nn;
                    if (dist >= 8 && room - nn >= 8) {
                        do {
                            memcpy(dst, sp, 8);
                            dst += 8; sp += 8;
                        } while (dst < lim);
                    } else if (dist < 8 && room - nn >= 16) {
                        uint8_t pat[16];
                        for (int k = 0; k < 16; k++)
                            pat[k] = sp[k % dist];
                        int64_t adv = dist * (16 / dist);
                        do {
                            memcpy(dst, pat, 16);
                            dst += adv;
                        } while (dst < lim);
                    } else {
                        while (dst < lim) *dst++ = *sp++;
                    }
                    op = lim;
                    c->match_len -= (int32_t)nn;
                } else {
                    /* reaches into pre-step history: copy the ring
                     * segment (static during the step, never overlaps
                     * the output) up to its contiguous run */
                    int64_t hk = dist - back_here;
                    uint32_t spos = (c->wpos - (uint32_t)hk) & 32767;
                    int64_t take = nn < hk ? nn : hk;
                    int64_t contig = 32768 - spos;
                    if (take > contig) take = contig;
                    memcpy(op, c->window + spos, (size_t)take);
                    op += take;
                    c->match_len -= (int32_t)take;
                }
            }
            c->state = ICX_BODY;
            continue;
        }
        if (c->state == ICX_STORED) {
            while (c->stored_rem > 0 && r.n >= 8) {
                if (op >= oend) ICX_SAVE_RET(2);
                *op++ = (uint8_t)br_bits(&r, 8);
                br_consume(&r, 8);
                c->stored_rem--;
            }
            while (c->stored_rem > 0 && r.in < r.end) {
                if (op >= oend) ICX_SAVE_RET(2);
                *op++ = *r.in++;
                c->stored_rem--;
            }
            if (c->stored_rem > 0) ICX_SAVE_RET(1);
            c->state = c->final_blk ? ICX_DONE : ICX_BLKSTART;
            continue;
        }
        if (c->state == ICX_BLKSTART) {
            const uint8_t *snap_in = r.in;
            uint64_t snap_buf = r.buf;
            int snap_n = r.n;
            icx_refill(&r);
            if (r.n < 3) ICX_RESTORE_RET(1);
            uint32_t hdr = br_bits(&r, 3);
            br_consume(&r, 3);
            c->final_blk = (int32_t)(hdr & 1);
            int btype = (int)(hdr >> 1);
            if (btype == 3) ICX_SAVE_RET(-1);
            if (btype == 0) {
                br_consume(&r, r.n & 7);
                icx_refill(&r);
                if (r.n < 32) ICX_RESTORE_RET(1);
                uint32_t len = br_bits(&r, 16); br_consume(&r, 16);
                uint32_t nlen = br_bits(&r, 16); br_consume(&r, 16);
                if (len != (~nlen & 0xFFFF)) ICX_SAVE_RET(-1);
                c->stored_rem = (int32_t)len;
                c->state = len ? ICX_STORED
                               : (c->final_blk ? ICX_DONE : ICX_BLKSTART);
                continue;
            }
            uint8_t dll[NUM_LITLEN], dof[NUM_OFFSET];
            if (btype == 1) {
                static_lens(dll, dof);
            } else {
                icx_refill(&r);
                if (r.n < 14) ICX_RESTORE_RET(1);
                int num_ll = (int)br_bits(&r, 5) + 257; br_consume(&r, 5);
                int num_of = (int)br_bits(&r, 5) + 1; br_consume(&r, 5);
                int ne = (int)br_bits(&r, 4) + 4; br_consume(&r, 4);
                if (num_ll > 286 || num_of > 30) ICX_SAVE_RET(-1);
                uint8_t plens[NUM_PRECODE] = {0};
                for (int k = 0; k < ne; k++) {
                    icx_refill(&r);
                    if (r.n < 3) ICX_RESTORE_RET(1);
                    plens[PRE_PERM[k]] = (uint8_t)br_bits(&r, 3);
                    br_consume(&r, 3);
                }
                int32_t ptab[1 << 7];
                if (build_table(plens, NUM_PRECODE, 7, ptab))
                    ICX_SAVE_RET(-1);
                uint8_t all[NUM_LITLEN + NUM_OFFSET];
                int tot = num_ll + num_of, i = 0;
                while (i < tot) {
                    icx_refill(&r);
                    int32_t e = ptab[br_bits(&r, 7)];
                    int l = e & 0xF;
                    if (!l) ICX_SAVE_RET(-1);
                    if (l > r.n) ICX_RESTORE_RET(1);
                    int sym = e >> 4;
                    if (sym <= 15) {
                        br_consume(&r, l);
                        all[i++] = (uint8_t)sym;
                    } else if (sym == 16) {
                        if (i == 0) ICX_SAVE_RET(-1);
                        if (l + 2 > r.n) ICX_RESTORE_RET(1);
                        br_consume(&r, l);
                        int rep = 3 + (int)br_bits(&r, 2);
                        br_consume(&r, 2);
                        if (i + rep > tot) ICX_SAVE_RET(-1);
                        for (int q = 0; q < rep; q++) {
                            all[i] = all[i - 1];
                            i++;
                        }
                    } else if (sym == 17) {
                        if (l + 3 > r.n) ICX_RESTORE_RET(1);
                        br_consume(&r, l);
                        int rep = 3 + (int)br_bits(&r, 3);
                        br_consume(&r, 3);
                        if (i + rep > tot) ICX_SAVE_RET(-1);
                        while (rep--) all[i++] = 0;
                    } else {
                        if (l + 7 > r.n) ICX_RESTORE_RET(1);
                        br_consume(&r, l);
                        int rep = 11 + (int)br_bits(&r, 7);
                        br_consume(&r, 7);
                        if (i + rep > tot) ICX_SAVE_RET(-1);
                        while (rep--) all[i++] = 0;
                    }
                }
                memset(dll, 0, sizeof dll);
                memset(dof, 0, sizeof dof);
                memcpy(dll, all, (size_t)num_ll);
                memcpy(dof, all + num_ll, (size_t)num_of);
                if (dll[256] == 0) ICX_SAVE_RET(-1);
            }
            if (build_table2(dll, NUM_LITLEN, LL_ROOT, c->ll_tab, 0, 0)
                    || build_table2(dof, NUM_OFFSET, 8, c->of_tab, 1, 0))
                ICX_SAVE_RET(-1);
            c->state = ICX_BODY;
            continue;
        }
        /* ICX_BODY fast burst: while a full word refill is available
         * and output has room, decode literal runs with no per-symbol
         * snapshot — no suspension can trigger inside (every decode is
         * covered by the n>=15 invariant), and every exit leaves the
         * reader at a symbol boundary for the checked path to resume.
         * Matches/EOB fall through to the per-symbol machinery (the
         * ring-buffer bulk copier amortizes their entry cost). */
        while (r.end - r.in >= 16 && op < oend) {
            br_refill(&r);
            int32_t e = c->ll_tab[(uint32_t)r.buf & LL_RMASK];
            for (;;) {
                if (E_TYPE(e) == T_SUB) {
                    e = c->ll_tab[E_PAY(e)
                        + ((uint32_t)(r.buf >> LL_ROOT)
                           & ((1u << E_EXTRA(e)) - 1))];
                    continue;
                }
                if (E_TYPE(e) == T_LIT) {
                    br_consume(&r, E_LEN(e));
                    *op++ = (uint8_t)E_PAY(e);
                    if (r.n < 15 || op >= oend) goto burst_spin;
                    e = c->ll_tab[(uint32_t)r.buf & LL_RMASK];
                    continue;
                }
                break;
            }
            /* inline match: decode + copy without the per-symbol
             * snapshot machinery when bits and output room suffice
             * (48-bit worst case after one refill; 274 = 258 max len
             * + 16-byte copy overshoot) */
            if (E_TYPE(e) == T_BASE && oend - op >= 274) {
                br_refill(&r);
                if (r.n < 48) break;
                uint32_t len, dist;
                {
                    uint64_t sv = r.buf;
                    int cl = E_LEN(e), ce = E_EXTRA(e);
                    br_consume(&r, cl + ce);
                    len = E_PAY(e)
                        + ((uint32_t)(sv >> cl) & ((1u << ce) - 1));
                }
                int32_t oe = c->of_tab[(uint32_t)r.buf & 255];
                if (E_TYPE(oe) == T_SUB)
                    oe = c->of_tab[E_PAY(oe)
                        + ((uint32_t)(r.buf >> 8)
                           & ((1u << E_EXTRA(oe)) - 1))];
                if (!E_LEN(oe)) ICX_SAVE_RET(-1);
                {
                    uint64_t sv = r.buf;
                    int ol = E_LEN(oe), oex = E_EXTRA(oe);
                    br_consume(&r, ol + oex);
                    dist = E_PAY(oe)
                        + ((uint32_t)(sv >> ol) & ((1u << oex) - 1));
                }
                if ((int64_t)dist > c->total_out + (op - out))
                    ICX_SAVE_RET(-1);
                if ((int64_t)dist <= op - out) {
                    /* source inside this step's output: copy with the
                     * one-shot decoder's tiers (overshoot covered) */
                    const uint8_t *sp = op - dist;
                    uint8_t *dst = op;
                    op += len;
                    if (dist >= 16) {
                        /* same hazards as the one-shot decoder: a
                         * wrapped contiguous copy store-forward
                         * stalls, so double the pattern (non-
                         * overlapping stages, avail multiple of dist) */
                        int64_t avail = dist;
                        for (;;) {
                            int64_t rem = op - dst;
                            if (avail < rem) {
                                memcpy(dst, dst - avail, (size_t)avail);
                                dst += avail;
                                avail <<= 1;
                            } else {
                                const uint8_t *s2 = dst - avail;
                                do {
                                    memcpy(dst, s2, 16);
                                    dst += 16; s2 += 16;
                                } while (dst < op);
                                break;
                            }
                        }
                    } else if (dist == 1) {
                        memset(dst, *sp, len + 15);
                    } else {
#if defined(__SSSE3__)
                        __m128i pv = _mm_shuffle_epi8(
                            _mm_loadu_si128((const __m128i *)sp),
                            _mm_load_si128(
                                (const __m128i *)PAT_MASK16[dist]));
                        int adv = (16 / (int)dist) * (int)dist;
                        do {
                            _mm_storeu_si128((__m128i *)dst, pv);
                            dst += adv;
                        } while (dst < op);
#else
                        uint8_t pat[16];
                        for (int k = 0; k < 16; k++)
                            pat[k] = sp[k % dist];
                        int adv = (16 / (int)dist) * (int)dist;
                        do {
                            memcpy(dst, pat, 16);
                            dst += adv;
                        } while (dst < op);
#endif
                    }
                    continue;
                }
                /* reaches pre-step history: the state machine's ring
                 * path handles it */
                c->match_len = (int32_t)len;
                c->match_dist = (int32_t)dist;
                c->state = ICX_MATCH;
                goto burst_state;
            }
            break;
burst_spin:;
        }
        if (0) {
burst_state:;
            continue;
        }
        /* ICX_BODY: one symbol per iteration, checked reads */
        {
            const uint8_t *snap_in = r.in;
            uint64_t snap_buf = r.buf;
            int snap_n = r.n;
            icx_refill(&r);
            int32_t e = c->ll_tab[br_bits(&r, LL_ROOT)];
            if (E_TYPE(e) == T_SUB)
                e = c->ll_tab[E_PAY(e)
                    + ((uint32_t)(r.buf >> LL_ROOT)
                       & ((1u << E_EXTRA(e)) - 1))];
            int l = E_LEN(e);
            if (!l) ICX_SAVE_RET(-1);
            if (l > r.n) ICX_RESTORE_RET(1);
            int ty = E_TYPE(e);
            if (ty == T_LIT) {
                if (op >= oend) ICX_RESTORE_RET(2);
                br_consume(&r, l);
                *op++ = (uint8_t)E_PAY(e);
                continue;
            }
            if (ty == T_EOB) {
                br_consume(&r, l);
                c->state = c->final_blk ? ICX_DONE : ICX_BLKSTART;
                continue;
            }
            /* match: length extra + offset code + offset extra, all
             * bounded by 48 bits after one refill */
            int leb = E_EXTRA(e);
            if (l + leb > r.n) ICX_RESTORE_RET(1);
            br_consume(&r, l);
            uint32_t len = E_PAY(e) + br_bits(&r, leb);
            br_consume(&r, leb);
            icx_refill(&r);
            int32_t oe = c->of_tab[br_bits(&r, 8)];
            if (E_TYPE(oe) == T_SUB)
                oe = c->of_tab[E_PAY(oe)
                    + ((uint32_t)(r.buf >> 8)
                       & ((1u << E_EXTRA(oe)) - 1))];
            int ol = E_LEN(oe);
            if (!ol) ICX_SAVE_RET(-1);
            int oeb = E_EXTRA(oe);
            if (ol + oeb > r.n) ICX_RESTORE_RET(1);
            br_consume(&r, ol);
            uint32_t dist = E_PAY(oe) + br_bits(&r, oeb);
            br_consume(&r, oeb);
            if ((int64_t)dist > c->total_out + (op - out))
                ICX_SAVE_RET(-1);
            c->match_len = (int32_t)len;
            c->match_dist = (int32_t)dist;
            c->state = ICX_MATCH;
            continue;
        }
    }
    (void)rc;
#undef ICX_SAVE_RET
#undef ICX_RESTORE_RET
}
