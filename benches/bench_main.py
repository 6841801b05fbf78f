#!/usr/bin/env python3
"""Comprehensive benchmark harness (reference benches/bench_main.rs parity).

Groups: Compress (levels x sizes xxs..xl), Decompress (source levels x
sizes), Checksums (large/micro/nano/tail/unaligned), per-offset decode
(1..64), Batch (compress+decompress), Stream (encode+decode), and the
Silesia-like mixed corpus (BASELINE.md's headline metric: level-6
compress+decompress throughput and ratio) — each head-to-head with TWO
control arms on the same machine: CPython zlib and C libdeflate
(benches/libdeflate_control.py), mirroring the reference's
criterion-vs-libdeflater method (reference benches/bench_main.rs:977-1122).

Writes benches/results.json and prints a table. Throughput is bytes/s of
UNCOMPRESSED data (the reference's convention).

Usage: python benches/bench_main.py [--quick] [--device] [--no-silesia]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
import zlib

# persistent XLA compile cache: JAX_COMPILATION_CACHE_DIR if set, else
# <repo>/.jax_cache (the device groups carry dozens of compiles)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "..", ".jax_cache"))

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import libdeflate_control as ldc  # noqa: E402  (control arm)


def pattern(size: int, seed: int = 1234) -> bytes:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, 100, dtype=np.uint8)
    data = np.tile(base, size // 100 + 1)[:size].copy()
    idx = rng.integers(0, size, size // 200)
    data[idx] = rng.integers(0, 256, len(idx), dtype=np.uint8)
    return data.tobytes()


def timeit(fn, *args, min_time: float = 0.2, max_iter: int = 50) -> float:
    fn(*args)  # warm
    n, t0 = 0, time.perf_counter()
    while True:
        fn(*args)
        n += 1
        dt = time.perf_counter() - t0
        if dt >= min_time or n >= max_iter:
            return dt / n


class Harness:
    def __init__(self) -> None:
        self.results: list[dict] = []

    def rec(self, group: str, name: str, nbytes: int, secs: float,
            zlib_secs: float | None = None, ld_secs: float | None = None,
            extra: dict | None = None) -> None:
        row = {"group": group, "name": name,
               "throughput_mbps": round(nbytes / secs / 1e6, 2)}
        line = f"{group:12s} {name:28s} {row['throughput_mbps']:9.1f} MB/s"
        if zlib_secs is not None:
            row["control_mbps"] = round(nbytes / zlib_secs / 1e6, 2)
            row["vs_control"] = round(zlib_secs / secs, 3)
            line += f"  [zlib x{row['vs_control']}"
            if ld_secs is not None:
                row["libdeflate_mbps"] = round(nbytes / ld_secs / 1e6, 2)
                row["vs_libdeflate"] = round(ld_secs / secs, 3)
                line += f"  libdeflate x{row['vs_libdeflate']}"
            line += "]"
        if extra:
            row.update(extra)
        self.results.append(row)
        print(line, flush=True)


def corpus_files(quick: bool) -> list[tuple[str, bytes]]:
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus")
    if not os.path.isdir(d) or not os.listdir(d):
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts"))
        import gen_silesia_like
        gen_silesia_like.generate(d)
    names = sorted(os.listdir(d))
    if quick:
        names = ["dickens", "mozilla", "nci", "sao"]
    return [(n, open(os.path.join(d, n), "rb").read()) for n in names]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", action="store_true",
                    help="include device (JAX) groups")
    ap.add_argument("--no-silesia", action="store_true")
    ap.add_argument("--only-device", action="store_true",
                    help="run just the device groups (fast re-measure)")
    ap.add_argument("--groups", default=None,
                    help="comma list of group prefixes to (re)run, e.g. "
                         "'compress,decompress' — other groups keep "
                         "their committed rows (results merge by name)")
    ap.add_argument("--rows", default=None,
                    help="substring filter over DEVICE row names (e.g. "
                         "'fused'); unmeasured device rows keep their "
                         "committed values (merge switches to by-name)")
    args = ap.parse_args()
    if args.only_device:
        args.device = True
    want = ([g.strip() for g in args.groups.split(",")]
            if args.groups else None)

    def group_on(g):
        return want is None or g in want

    def row_on(name_sub):
        return args.rows is None or args.rows in name_sub

    import libdeflate_rsx_tpu as ld

    h = Harness()
    rec = h.rec
    have_ldc = ldc.available()

    sizes = {"xxs": 1 << 10, "xs": 16 << 10, "s": 64 << 10, "m": 1 << 20}
    if not args.quick:
        sizes["l"] = 4 << 20
        sizes["xl"] = 64 << 20

    if args.only_device:
        sizes = {}
    # -- Compress (host engine) -------------------------------------------
    levels = [1, 6] if args.quick else [1, 6, 9, 10, 12]
    for name, size in sizes.items() if group_on("compress") else []:
        data = pattern(size)
        for level in levels:
            if level >= 10 and size > (1 << 20):
                continue  # DP parser tier: keep the bench bounded
            if level == 9 and size > (4 << 20):
                continue
            c = ld.Compressor(level)
            secs = timeit(c.compress_deflate, data)
            zsecs = timeit(lambda d: zlib.compress(d, min(level, 9)), data)
            lsecs = timeit(
                lambda d: ldc.compress(d, level), data) if have_ldc else None
            rec("compress", f"level{level}/{name}", size, secs, zsecs, lsecs)

    # -- Decompress (host C decoder; sources from several levels) ----------
    dec_levels = [6] if args.quick else [1, 6, 9]
    for name, size in sizes.items() if group_on("decompress") else []:
        data = pattern(size)
        for lvl in dec_levels:
            comp = zlib.compress(data, lvl)[2:-4]
            d = ld.Decompressor()
            secs = timeit(d.decompress_deflate, comp, size)
            zsecs = timeit(lambda c: zlib.decompress(c, -15), comp)
            lsecs = timeit(lambda c: ldc.decompress(c, size),
                           comp) if have_ldc else None
            rec("decompress", f"level{lvl}/{name}", size, secs, zsecs, lsecs)

    # -- Checksums ----------------------------------------------------------
    for name, size in [] if (args.only_device
                             or not group_on("checksums")) else [
                       ("large", 4 << 20), ("micro", 4096), ("nano", 64),
                       ("tail", 1031), ("unaligned", (1 << 20) + 1)]:
        data = pattern(size)
        secs = timeit(ld.crc32, data)
        zsecs = timeit(zlib.crc32, data)
        lsecs = timeit(ldc.crc32, data) if have_ldc else None
        rec("crc32", name, size, secs, zsecs, lsecs)
        secs = timeit(ld.adler32, data)
        zsecs = timeit(zlib.adler32, data)
        lsecs = timeit(ldc.adler32, data) if have_ldc else None
        rec("adler32", name, size, secs, zsecs, lsecs)

    # -- Per-offset decode (reference offsets 1..64 sweep) ------------------
    offsets = [] if (args.only_device or not group_on("offset")) else (
        [3, 8, 18] if args.quick else list(range(1, 65)))
    for off in offsets:
        base = bytes((37 * i + 11) % 256 for i in range(off))
        data = (base * ((1 << 20) // off + 1))[: 1 << 20]
        comp = zlib.compress(data, 9)[2:-4]
        d = ld.Decompressor()
        secs = timeit(d.decompress_deflate, comp, len(data), min_time=0.08)
        zsecs = timeit(lambda c: zlib.decompress(c, -15), comp,
                       min_time=0.08)
        lsecs = timeit(lambda c: ldc.decompress(c, len(data)), comp,
                       min_time=0.08) if have_ldc else None
        rec("offset", f"decode/off{off}", len(data), secs, zsecs, lsecs)

    # -- Batch ---------------------------------------------------------------
    chunks = [pattern(32 << 10, seed=i) for i in range(32)]
    for level in () if (args.only_device
                        or not group_on("batch")) else (1, 6):
        bc = ld.BatchCompressor(level=level)
        secs = timeit(bc.compress_batch, chunks)
        zsecs = timeit(lambda cs: [zlib.compress(c, level) for c in cs],
                       chunks)
        lsecs = timeit(lambda cs: [ldc.compress(c, level) for c in cs],
                       chunks) if have_ldc else None
        rec("batch", f"compress/32x32KB/level{level}",
            32 * (32 << 10), secs, zsecs, lsecs)
    if args.only_device:
        comp_chunks = []
    else:
        comp_chunks = [zlib.compress(c, 6)[2:-4] for c in chunks]
    if not args.only_device and group_on("batch"):
        caps = [32 << 10] * len(chunks)
        bd = ld.BatchDecompressor()
        secs = timeit(bd.decompress_batch, comp_chunks, caps)
        zsecs = timeit(lambda cs: [zlib.decompress(c, -15) for c in cs],
                       comp_chunks)
        lsecs = timeit(lambda cs: [ldc.decompress(c, 32 << 10)
                                   for c in cs],
                       comp_chunks) if have_ldc else None
        rec("batch", "decompress/32x32KB", 32 * (32 << 10), secs, zsecs,
            lsecs)

    if not args.only_device and group_on("stream"):
        # -- Stream -----------------------------------------------------------
        data = pattern(2 << 20)

        def stream_encode(d):
            sink = io.BytesIO()
            with ld.DeflateEncoder(sink, level=6) as enc:
                enc.write(d)
            return sink.getvalue()

        def zlib_stream_encode(d):
            co = zlib.compressobj(6, zlib.DEFLATED, -15)
            out = co.compress(d)
            return out + co.flush()

        secs = timeit(stream_encode, data)
        zsecs = timeit(zlib_stream_encode, data)
        lsecs = timeit(ldc.compress, data, 6) if have_ldc else None
        rec("stream", "encode/2MB/level6", len(data), secs, zsecs, lsecs)

        # the reference's encoder_perf bench is a 10 MB parallel stream
        # encode at level 6 (reference benches/encoder_perf.rs:5-28)
        data10 = pattern(10 << 20)
        secs = timeit(stream_encode, data10)
        zsecs = timeit(zlib_stream_encode, data10)
        lsecs = timeit(ldc.compress, data10, 6) if have_ldc else None
        rec("stream", "encode/10MB/level6", len(data10), secs, zsecs, lsecs)

        comp = zlib.compress(data, 6)[2:-4]

        def stream_decode(c):
            return ld.DeflateDecoder(io.BytesIO(c)).read()

        secs = timeit(stream_decode, comp)
        zsecs = timeit(lambda c: zlib.decompress(c, -15), comp)
        rec("stream", "decode/2MB/level6", len(data), secs, zsecs)

        class _NonSeekable:
            """Socket-like reader: no seekable(), so the decoder must
            ride the resumable engine, not the whole-stream fast path"""
            def __init__(self, buf):
                self._b, self._p = buf, 0

            def read(self, n):
                out = self._b[self._p:self._p + n]
                self._p += len(out)
                return out

        def stream_decode_ns(c):
            return ld.DeflateDecoder(_NonSeekable(c)).read()

        assert stream_decode_ns(comp) == data
        secs = timeit(stream_decode_ns, comp)
        rec("stream", "decode-nonseekable/2MB/level6", len(data), secs,
            zsecs)

    # -- Silesia-like corpus (BASELINE.md headline metric) --------------------
    if (not args.no_silesia and not args.only_device
            and group_on("silesia")):
        members = corpus_files(args.quick)
        # levels {1,6,9,10} are the reference's head-to-head set
        # (reference benches/bench_main.rs:977-1028); 12 adds our
        # max-ratio tier
        for level in ([6] if args.quick else [1, 6, 9, 10, 12]):
            tot = {"n": 0, "ours": 0.0, "zlib": 0.0, "ld": 0.0,
                   "ours_c": 0, "zlib_c": 0, "ld_c": 0}
            for mname, data in members:
                c = ld.Compressor(level)
                ours = c.compress_deflate(data)
                secs = timeit(c.compress_deflate, data, min_time=0.1,
                              max_iter=5)
                # zlib caps at 9; levels 10-12 bench against the
                # level-9-class control (the reference's convention)
                zl = min(level, 9)
                zc = zlib.compress(data, zl)[2:-4]
                zsecs = timeit(lambda d: zlib.compress(d, zl), data,
                               min_time=0.1, max_iter=5)
                lc = ldc.compress(data, level) if have_ldc else b"?"
                lsecs = timeit(lambda d: ldc.compress(d, level), data,
                               min_time=0.1, max_iter=5) if have_ldc else None
                rec("silesia", f"compress/level{level}/{mname}",
                    len(data), secs, zsecs, lsecs,
                    extra={"ratio": round(len(data) / len(ours), 3),
                           "zlib_ratio": round(len(data) / len(zc), 3),
                           "libdeflate_ratio":
                               round(len(data) / len(lc), 3)})
                tot["n"] += len(data)
                tot["ours"] += secs
                tot["zlib"] += zsecs
                tot["ld"] += lsecs or 0.0
                tot["ours_c"] += len(ours)
                tot["zlib_c"] += len(zc)
                tot["ld_c"] += len(lc)
            rec("silesia", f"compress/level{level}/TOTAL", tot["n"],
                tot["ours"], tot["zlib"], tot["ld"] if have_ldc else None,
                extra={"ratio": round(tot["n"] / tot["ours_c"], 3),
                       "zlib_ratio": round(tot["n"] / tot["zlib_c"], 3),
                       "libdeflate_ratio":
                           round(tot["n"] / tot["ld_c"], 3)})
        # decompress from sources at each level (the reference benches
        # decode from multiple source levels, reference
        # benches/bench_main.rs:1057-1122); level-12 sources come from
        # our own DP tier
        for src_level in ([6] if args.quick else [1, 6, 9, 12]):
            tot = {"n": 0, "ours": 0.0, "zlib": 0.0, "ld": 0.0}
            for mname, data in members:
                if src_level <= 9:
                    comp = zlib.compress(data, src_level)[2:-4]
                else:
                    comp = ld.Compressor(src_level).compress_deflate(data)
                d = ld.Decompressor()
                secs = timeit(d.decompress_deflate, comp, len(data),
                              min_time=0.1, max_iter=8)
                zsecs = timeit(lambda c: zlib.decompress(c, -15), comp,
                               min_time=0.1, max_iter=8)
                lsecs = timeit(lambda c: ldc.decompress(c, len(data)),
                               comp, min_time=0.1, max_iter=8) \
                    if have_ldc else None
                rec("silesia", f"decompress/level{src_level}/{mname}",
                    len(data), secs, zsecs, lsecs)
                tot["n"] += len(data)
                tot["ours"] += secs
                tot["zlib"] += zsecs
                tot["ld"] += lsecs or 0.0
            rec("silesia", f"decompress/level{src_level}/TOTAL",
                tot["n"], tot["ours"], tot["zlib"],
                tot["ld"] if have_ldc else None)

    # -- Device groups --------------------------------------------------------
    # Sustained on-device throughput (device-resident inputs, scalar
    # readback sync) on a CUDA GPU; the card's name and power limit are
    # printed beside the rows.
    if args.device:
        import functools

        import jax
        import jax.numpy as jnp

        from libdeflate_rsx_tpu.models.greedy_dynamic import (
            deflate_device_dynamic)
        from libdeflate_rsx_tpu.models.greedy_static import (
            deflate_device_static)
        from libdeflate_rsx_tpu.ops import encode_v2 as e2
        from libdeflate_rsx_tpu.ops.encode_dynamic import (
            build_tables_host, jit_analyze, jit_emit)

        def best_of(fn, reps=6):
            best = 1e9
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            return best

        if jax.default_backend() != "gpu":
            sys.exit("--device needs a CUDA GPU; JAX backend is "
                     f"{jax.default_backend()!r}")
        import subprocess
        print("card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())

        # every device probe runs K launches inside ONE jit (inputs
        # perturbed per iteration, single scalar sync) and divides
        K_DEV = 4

        BLOCK, ROWS, UNROLL = 65536, 16, 4
        _row_static = row_on("compress/static-tier/sustained")
        _row_dynamic = row_on("compress/dynamic-tier/sustained")
        _row_l6 = row_on("compress/l6-tier/sustained")
        if _row_static or _row_dynamic:
            size = UNROLL * ROWS * BLOCK
            data = pattern(size)
            # correctness gate for both tiers (end-to-end through zlib)
            assert zlib.decompress(
                deflate_device_static(data[: 4 * BLOCK], BLOCK), -15) \
                == data[: 4 * BLOCK]
            assert zlib.decompress(
                deflate_device_dynamic(data[: 4 * BLOCK], BLOCK), -15) \
                == data[: 4 * BLOCK]

            arr = np.zeros((UNROLL, ROWS, BLOCK + e2.BLOCK_PAD), np.uint8)
            arr[:, :, :BLOCK] = np.frombuffer(data, np.uint8).reshape(
                UNROLL, ROWS, BLOCK)
            a = jnp.asarray(arr)
            v = jnp.asarray(np.full((UNROLL, ROWS), BLOCK, np.int32))
            fin = jnp.asarray(np.zeros((UNROLL, ROWS), bool))

        if _row_static:
            enc = e2.jit_encoder_scan(BLOCK, UNROLL)

            @jax.jit
            def probe_static(a_, v_, f_):
                def body(i, acc):
                    o = enc(a_ + i.astype(jnp.uint8), v_, f_)
                    return acc + o[4].sum() + o[0].reshape(-1)[0].astype(
                        jnp.int32)
                return jax.lax.fori_loop(0, K_DEV, body, jnp.int32(0))

            int(probe_static(a, v, fin))
            secs = best_of(lambda: int(probe_static(a, v, fin))) / K_DEV
            zsecs = timeit(lambda d: zlib.compress(d, 1), data)
            rec("device", "compress/static-tier/sustained", size, secs, zsecs)

        if _row_dynamic:
            # dynamic tier: jit A + host tables + jit B, device-resident
            a2 = a[0]
            v2 = v[0]
            ja = jit_analyze(BLOCK)
            je = jit_emit(BLOCK)
            outA = ja(a2, v2)
            jax.block_until_ready(outA)
            finals = np.zeros(ROWS, bool)
            ll, of, hdrs, hb = build_tables_host(outA[4], outA[5], finals)
            llj, ofj = jnp.asarray(ll), jnp.asarray(of)
            hbj = jnp.asarray(hb.astype(np.int32))

            @jax.jit
            def probe_dynA(a_, v_):
                def body(i, acc):
                    o = ja(a_ + i.astype(jnp.uint8), v_)
                    return acc + o[4].sum() + o[0].reshape(-1)[0]
                return jax.lax.fori_loop(0, K_DEV, body, jnp.int32(0))

            @jax.jit
            def probe_dynB(a_, *rest):
                def body(i, acc):
                    o = je(a_ + i.astype(jnp.uint8), *rest)
                    return acc + o[3].sum() + o[0].reshape(-1)[0].astype(
                        jnp.int32)
                return jax.lax.fori_loop(0, K_DEV, body, jnp.int32(0))

            int(probe_dynA(a2, v2))
            tA = best_of(lambda: int(probe_dynA(a2, v2))) / K_DEV
            args_b = (outA[0], outA[1], outA[2], outA[3], llj, ofj, hbj)
            int(probe_dynB(a2, *args_b))
            tB = best_of(lambda: int(probe_dynB(a2, *args_b))) / K_DEV
            # host table step, batched: production (BatchCompressor /
            # deflate_device_dynamic_many) fetches the histograms for the
            # WHOLE batch in one transfer, paying the host round trip
            # once instead of per chunk
            NBATCH = 8
            outA_b = ja(jnp.concatenate([a2 + k for k in range(NBATCH)]),
                        jnp.concatenate([v2] * NBATCH))
            jax.block_until_ready(outA_b)
            finals_b = np.zeros(ROWS * NBATCH, bool)
            t0 = time.perf_counter()
            build_tables_host(outA_b[4], outA_b[5], finals_b)
            tH = (time.perf_counter() - t0) / NBATCH
            chunk = ROWS * BLOCK
            secs = tA + tB + tH
            zsecs = timeit(lambda d: zlib.compress(d, 6), data[:chunk])
            tdata = corpus_files(True)[0][1]            # dickens
            comp = deflate_device_dynamic(tdata)
            scomp = deflate_device_static(tdata)
            rec("device", "compress/dynamic-tier/sustained", chunk, secs,
                zsecs, extra={
                    "dickens_ratio": round(len(tdata) / len(comp), 3),
                    "static_ratio": round(len(tdata) / len(scomp), 3),
                    "zlib6_ratio": round(
                        len(tdata) / len(zlib.compress(tdata, 6)), 3),
                    # breakdown: tA/tB are device phases, tH is the batched
                    # host table step including the histogram fetch
                    "tA_ms": round(tA * 1e3, 2),
                    "tB_ms": round(tB * 1e3, 2),
                    "tH_host+link_ms": round(tH * 1e3, 2)})

        if _row_l6:
            # L6 ratio tier (strided prefix ladder + 32 KiB history):
            # device analyze + batched host tables + device emit; ratio
            # extras against libdeflate-6 on dickens
            from libdeflate_rsx_tpu.models.greedy_dynamic import (
                deflate_device_l6, split_blocks_hist)
            from libdeflate_rsx_tpu.ops.encode_dynamic import (
                HIST, jit_analyze_l6)
            data6 = pattern(ROWS * BLOCK)
            assert zlib.decompress(
                deflate_device_l6(data6[: 2 * BLOCK], BLOCK), -15) \
                == data6[: 2 * BLOCK]
            arrL, validL, hsL, finL, numL = split_blocks_hist(data6, BLOCK)
            aL = jnp.asarray(arrL)
            vL = jnp.asarray(validL)
            hL = jnp.asarray(hsL)
            jaL = jit_analyze_l6(BLOCK)
            outAL = jaL(aL, vL, hL)
            jax.block_until_ready(outAL)
            llL, ofL, hdrsL, hbL = build_tables_host(
                outAL[4], outAL[5], np.zeros(numL, bool))
            lljL, ofjL = jnp.asarray(llL), jnp.asarray(ofL)
            hbjL = jnp.asarray(hbL.astype(np.int32))
            jeL = jit_emit(BLOCK)

            @jax.jit
            def probe_l6A(a_, v_, h_):
                def body(i, acc):
                    o = jaL(a_ + i.astype(jnp.uint8), v_, h_)
                    return acc + o[4].sum().astype(jnp.int32) \
                        + o[0].reshape(-1)[0]
                return jax.lax.fori_loop(0, K_DEV, body, jnp.int32(0))

            @jax.jit
            def probe_l6B(a_, *rest):
                def body(i, acc):
                    o = jeL(a_ + i.astype(jnp.uint8), *rest)
                    return acc + o[3].sum() + o[0].reshape(-1)[0].astype(
                        jnp.int32)
                return jax.lax.fori_loop(0, K_DEV, body, jnp.int32(0))

            int(probe_l6A(aL, vL, hL))
            tAL = best_of(lambda: int(probe_l6A(aL, vL, hL))) / K_DEV
            argsL = (outAL[0], outAL[1], outAL[2], outAL[3], lljL, ofjL,
                     hbjL)
            int(probe_l6B(aL[:, HIST:], *argsL))
            tBL = best_of(lambda: int(probe_l6B(aL[:, HIST:], *argsL))) / K_DEV
            t0 = time.perf_counter()
            build_tables_host(outAL[4], outAL[5], np.zeros(numL, bool))
            tHL = time.perf_counter() - t0
            chunk = ROWS * BLOCK
            secs = tAL + tBL + tHL
            zsecs = timeit(lambda d: zlib.compress(d, 6), data6[:chunk])
            tdata = corpus_files(True)[0][1]            # dickens
            compL = deflate_device_l6(tdata)
            rec("device", "compress/l6-tier/sustained", chunk, secs,
                zsecs, extra={
                    "dickens_ratio": round(len(tdata) / len(compL), 3),
                    "libdeflate6_dickens_ratio": round(
                        len(tdata) / len(ldc.compress(tdata, 6)), 3)
                    if have_ldc else None,
                    "tA_ms": round(tAL * 1e3, 2),
                    "tB_ms": round(tBL * 1e3, 2),
                    "tH_host+link_ms": round(tHL * 1e3, 2)})

        _dec_rows = ("decompress/16x64KB/sustained",
                     "decompress/128x64KB/sustained",
                     "decompress/128x64KB/fused-sustained")
        if any(row_on(n) for n in _dec_rows):
            # batch decode: lockstep two-pass decoder (pass-1 entropy
            # decode kernel, ops/pallas/inflate_tokens.py). TWO input sets
            # alternate inside the loop so XLA cannot hoist the kernel.
            from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as itk
            chunks = [pattern(BLOCK - 1024, seed=i) for i in range(16)]
            comps = [zlib.compress(c, 6)[2:-4] for c in chunks]
            outs = itk.inflate_device_tokens(comps)
            assert all(o == c for o, c in zip(outs, chunks))

            def dec_inputs(n_streams):
                cs = [pattern(BLOCK - 1024, seed=i) for i in range(n_streams)]
                za = [zlib.compress(c, 6)[2:-4] for c in cs]
                zb = [zlib.compress(pattern(BLOCK - 1024, seed=500 + i),
                                    6)[2:-4] for i in range(n_streams)]
                programs, lanes = itk.layout(n_streams)
                ia, wa_, _ = itk.pack_streams(za, programs * lanes)
                ib_, wb_, _ = itk.pack_streams(zb, programs * lanes)
                run = itk._jit_pass1(programs, lanes, 72 * 1024)
                return (cs, za, run, jnp.asarray(ia), jnp.asarray(wa_),
                        jnp.asarray(ib_), jnp.asarray(wb_))

            def dec_row(name, n_streams):
                cs, za, run, ja, jwa, jb, jwb = dec_inputs(n_streams)

                @jax.jit
                def probe_dec(la_, wa2, lb_, wb2):
                    def body(i, acc):
                        l_ = jnp.where(i % 2 == 0, la_, lb_)
                        w_ = jnp.where(i % 2 == 0, wa2, wb2)
                        toks, stats = run(l_, w_)
                        return acc + stats[1].sum() + toks[0, 0]
                    return jax.lax.fori_loop(0, K_DEV, body, jnp.int32(0))

                int(probe_dec(ja, jwa, jb, jwb))
                secs = best_of(lambda: int(probe_dec(ja, jwa, jb, jwb))) / K_DEV
                tot2 = sum(len(c) for c in cs)
                zsecs2 = timeit(lambda xs: [zlib.decompress(c, -15)
                                            for c in xs], za)
                rec("device", name, tot2, secs, zsecs2)

            if row_on("decompress/16x64KB/sustained"):
                dec_row("decompress/16x64KB/sustained", 16)
            if row_on("decompress/128x64KB/sustained"):
                dec_row("decompress/128x64KB/sustained", 128)

            def dec_row_fused(name, n_streams):
                """FULL device decode: pass-1 token kernel + the on-device
                LZ resolution pass (ops/resolve.py) in one jit — decoded
                bytes are the only output (the pass-1-only rows above
                isolate the entropy kernel)."""
                cs, za, run, ja, jwa, jb, jwb = dec_inputs(n_streams)
                # correctness gate end-to-end through the public wrapper
                outs2 = itk.inflate_device_fused(za, max_steps=72 * 1024)
                assert outs2 == cs
                programs, lanes = itk.layout(n_streams)
                res = itk._jit_resolve_tok(
                    65536, itk.resolve_columns(n_streams, programs * lanes))

                @jax.jit
                def probe_f(la_, wa2, lb_, wb2):
                    def body(i, acc):
                        l_ = jnp.where(i % 2 == 0, la_, lb_)
                        w_ = jnp.where(i % 2 == 0, wa2, wb2)
                        toks, stats = run(l_, w_)
                        outb, outlen, okf = res(toks)
                        return (acc + outlen.sum()
                                + outb.reshape(-1)[0].astype(jnp.int32)
                                + stats[1].sum())
                    return jax.lax.fori_loop(0, K_DEV, body, jnp.int32(0))

                int(probe_f(ja, jwa, jb, jwb))
                secs = best_of(lambda: int(probe_f(ja, jwa, jb, jwb))) / K_DEV
                tot2 = sum(len(c) for c in cs)
                zsecs2 = timeit(lambda xs: [zlib.decompress(c, -15)
                                            for c in xs], za)
                rec("device", name, tot2, secs, zsecs2)

            if row_on("decompress/128x64KB/fused-sustained"):
                dec_row_fused("decompress/128x64KB/fused-sustained", 128)

        if row_on("crc32") or row_on("adler32"):
            from libdeflate_rsx_tpu.ops import checksums as dcs

            data = pattern(8 << 20)
            assert dcs.crc32_device(data) == zlib.crc32(data)
            assert dcs.adler32_device(data) == zlib.adler32(data)
            n8 = len(data)
            arr_c = jnp.asarray(dcs._pad_to(
                np.frombuffer(data, np.uint8), dcs.CRC_CHUNK))
            arr_a = jnp.asarray(dcs._pad_to(
                np.frombuffer(data, np.uint8), dcs.ADLER_CHUNK))
            crc_fn = dcs._jit_crc(arr_c.shape[0], n8)
            adl_fn = dcs._jit_adler(arr_a.shape[0], n8)
            for name2, fn2, arr2, init2, ctrl in (
                    ("crc32", crc_fn, arr_c, jnp.uint32(0), zlib.crc32),
                    ("adler32", adl_fn, arr_a, jnp.uint32(1), zlib.adler32)):
                if not row_on(f"{name2}/8MB/sustained"):
                    continue
                # perturb the DATA per iteration: only folding the init
                # value would let XLA hoist the heavy data pass. The
                # matmul checksums are fast enough that K_DEV iterations
                # would drown in the launch overhead — loop K_CK times.
                K_CK = 256
                lfn = jax.jit(lambda a_, i0, f=fn2: jax.lax.fori_loop(
                    0, K_CK,
                    lambda i, acc: acc + f(
                        a_.at[0].set(i.astype(jnp.uint8)), i0),
                    jnp.uint32(0)))
                int(lfn(arr2, init2))
                secs = best_of(lambda: int(lfn(arr2, init2))) / K_CK
                zsecs = timeit(ctrl, data)
                rec("device", f"{name2}/8MB/sustained", n8, secs, zsecs)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results.json")
    results = h.results
    if os.path.exists(out):
        # merge: refresh the groups this run measured, keep the rest
        # (e.g. a host-only run preserves the device rows and vice versa)
        with open(out) as f:
            prior = json.load(f)
        if args.rows:
            # surgical --rows rerun: merge by (group, name) so the
            # device rows this run did NOT measure keep their values
            measured_n = {(r["group"], r["name"]) for r in results}
            results = [r for r in prior
                       if (r["group"], r["name"]) not in measured_n] \
                + results
        else:
            measured = {r["group"] for r in results}
            results = [r for r in prior
                       if r["group"] not in measured] + results
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\n{len(results)} results -> {out}")


if __name__ == "__main__":
    main()
