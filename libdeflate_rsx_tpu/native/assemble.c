/* Ragged row placement for the device block encoder (host runtime).
 *
 * The device returns per-row bit-aligned byte buffers plus each row's
 * global byte offset; the final DEFLATE stream is their OR-merge
 * (consecutive rows share at most one boundary byte, and the shared
 * byte's bit ranges are disjoint, so OR is exact). The numpy fallback
 * does this with boolean-mask fancy indexing (~50 M elem/s); this C
 * loop runs at memcpy-like speed.
 *
 * Native-runtime parity note: the reference implements its whole host
 * path natively (Rust); here the device does the compression math and
 * this kernel is the byte-granular tail the host owns.
 */

#include <stdint.h>
#include <stddef.h>

void assemble_rows(uint8_t *out,             /* (nblocks, out_cap) */
                   const uint8_t *rows,      /* (nblocks, nrows, w) */
                   const int64_t *byte_off,  /* (nblocks, nrows) */
                   const int64_t *extent,    /* (nblocks, nrows) */
                   int64_t nblocks, int64_t nrows, int64_t w,
                   int64_t out_cap) {
    for (int64_t b = 0; b < nblocks; b++) {
        uint8_t *ob = out + b * out_cap;
        const uint8_t *rb = rows + b * nrows * w;
        const int64_t *off = byte_off + b * nrows;
        const int64_t *ext = extent + b * nrows;
        for (int64_t r = 0; r < nrows; r++) {
            int64_t e = ext[r];
            int64_t o = off[r];
            if (e <= 0 || o < 0) continue;
            if (o + e > out_cap) {
                e = out_cap - o;
                if (e <= 0) continue;
            }
            uint8_t *dst = ob + o;
            const uint8_t *src = rb + r * w;
            /* first byte may share bits with the previous row's tail */
            dst[0] |= src[0];
            for (int64_t k = 1; k < e; k++) dst[k] |= src[k];
        }
    }
}
