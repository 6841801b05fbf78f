"""End-to-end smoke run of the batch codec on one CUDA GPU.

    python chip_smoke.py                # one card: the main path
    python chip_smoke.py --four-cards   # the sharded path on four cards

One card: the Silesia-like corpus (scripts/gen_silesia_like.py, made
from its seed) is cut into 1 MiB items and compressed through the
public batch API at level 6 (gzip) and level 1 (zlib) on the device;
every item must decode byte-exact with CPython. The corpus cut into
64 KiB slices and gzipped by CPython is decoded by the device batch
decoder under both resolve modes, byte-exact with zero host fallbacks.
The compiled pass-1 kernel and the device resolver are checked against
the numpy resolver on the tokens (tests/device_checks.py), at 64 KiB and
in the 1 MiB cap bucket, and the device checksums against zlib on the
whole corpus.

--four-cards runs only the sharded path: ShardedCompressor (gzip,
static and dynamic tiers) and ShardedDecompressor on the 64 KiB
streams, each compared with CPython, and checks that every card decodes
its own shard.

Timings printed before the last line are information. The last line is
one JSON object naming the device. Any failed check raises; without a
GPU the script exits non-zero before it runs anything.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
ITEM = 1 << 20
SLICE = 65536


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def corpus() -> bytes:
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import gen_silesia_like

    paths = gen_silesia_like.generate(os.path.join(ROOT, "benches",
                                                   "corpus"))
    return b"".join(open(p, "rb").read() for p in paths)


def compress_phase(data: bytes) -> None:
    from libdeflate_rsx_tpu import batch
    from libdeflate_rsx_tpu.engine import compress_raw
    from libdeflate_rsx_tpu.models.portable.deflate import Flush

    items = [data[i:i + ITEM] for i in range(0, len(data), ITEM)]
    for level, fmt, check in ((6, "gzip", gzip.decompress),
                              (1, "zlib", zlib.decompress)):
        comp = batch.BatchCompressor(level=level, format=fmt,
                                     use_device=True)
        outs, cold = timed(lambda: comp.compress_batch(items))
        outs, warm = timed(lambda: comp.compress_batch(items))
        for i, (item, out) in enumerate(zip(items, outs)):
            assert check(out) == item, f"L{level} {fmt} item {i}"
        dev = sum(map(len, outs))
        host = sum(len(compress_raw(x, level, Flush.FINISH))
                   for x in items)
        log(f"compress L{level} {fmt}: {len(items)} items byte-exact; "
            f"ratio {len(data) / dev:.4f} (host engine L{level} "
            f"{len(data) / host:.4f}); first call {cold:.2f}s, "
            f"warm {warm:.2f}s")


def l6_phase_times(data: bytes) -> None:
    """Compile (first call) and warm times of the L6 tier's phases on
    one 1 MiB item: device analyze, host tables, device emit."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libdeflate_rsx_tpu.models.greedy_dynamic import (
        DEFAULT_BLOCK, split_blocks_hist)
    from libdeflate_rsx_tpu.ops.encode_dynamic import (
        HIST, build_tables_host, jit_analyze_l6, jit_emit)

    arr, valid, hist_start, finals, _ = split_blocks_hist(
        data[:ITEM], DEFAULT_BLOCK)
    a, v, h = jnp.asarray(arr), jnp.asarray(valid), jnp.asarray(hist_start)
    analyze, emit = jit_analyze_l6(DEFAULT_BLOCK), jit_emit(DEFAULT_BLOCK)
    for run in ("first call", "warm"):
        outA, tA = timed(lambda: jax.block_until_ready(analyze(a, v, h)))
        tabs, tH = timed(lambda: build_tables_host(outA[4], outA[5],
                                                   finals))
        ll, of, _, hb = tabs
        _, tE = timed(lambda: jax.block_until_ready(emit(
            a[:, HIST:], *outA[:4], jnp.asarray(ll), jnp.asarray(of),
            jnp.asarray(hb.astype(np.int32)))))
        log(f"L6 phases ({run}, 1 MiB): analyze {tA:.4f}s, host tables "
            f"{tH:.4f}s, emit {tE:.4f}s")


def load_device_checks():
    """tests/device_checks.py, loaded by path: another installed package
    may also be named `tests`."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "device_checks", os.path.join(ROOT, "tests", "device_checks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gzip_slices(data: bytes):
    slices = [data[i:i + SLICE] for i in range(0, len(data), SLICE)]
    return slices, [gzip.compress(s, 6) for s in slices]


def decompress_phase(data: bytes) -> None:
    from libdeflate_rsx_tpu import batch

    slices, objs = gzip_slices(data)
    caps = [len(s) for s in slices]
    for resolve in ("device", "host"):
        dec = batch.BatchDecompressor(format="gzip", use_device=True,
                                      resolve=resolve)
        dec.decompress_batch(objs, caps)
        batch.reset_counters()
        outs, warm = timed(lambda: dec.decompress_batch(objs, caps))
        assert outs == slices, f"resolve={resolve}: output differs"
        assert batch.counters == {"device_items": len(objs),
                                  "host_fallback_items": 0}, batch.counters
        log(f"decompress gzip resolve={resolve}: {len(objs)} objects "
            f"byte-exact, CRC-verified, counters {batch.counters}; "
            f"warm {warm:.4f}s")


def kernel_phase(data: bytes) -> None:
    import jax
    import numpy as np

    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    device_checks = load_device_checks()

    slices = [data[i:i + SLICE] for i in range(0, len(data), SLICE)]
    info, t = timed(lambda: device_checks.check_decode(slices))
    log(f"pass 1 + resolvers vs numpy resolver at 64 KiB: {info} "
        f"({t:.1f}s with the checks)")
    big = [data[i:i + ITEM] for i in range(0, len(data), 4 * ITEM)]
    info, t = timed(lambda: device_checks.check_decode(big))
    log(f"pass 1 + resolvers vs numpy resolver, 1 MiB cap bucket: "
        f"{info} ({t:.1f}s with the checks)")
    _, t = timed(lambda: device_checks.check_checksums(data))
    log(f"device crc32 + adler32 == zlib on {len(data)} bytes "
        f"({t:.2f}s with compile)")

    # pass-1 and device-resolve times on the 64 KiB slices
    streams = [device_checks.raw_deflate(s) for s in slices]
    programs, lanes = it.layout(len(streams))
    inbits, words, _ = it.pack_streams(streams, programs * lanes)
    inbits, words = jax.device_put(inbits), jax.device_put(words)
    run = it._jit_pass1(programs, lanes, it.steps_for_caps([SLICE]))
    n = len(streams)
    ncols = it.resolve_columns(n, programs * lanes)
    for name, fn in (("pass 1", lambda: run(inbits, words)),
                     (f"pass 1 + device resolve of {ncols} columns",
                      lambda: it.resolve_tokens_device(
                          run(inbits, words)[0], n, SLICE))):
        ts = [timed(lambda: jax.block_until_ready(fn()))[1]
              for _ in range(4)]
        log(f"{name} ({n} streams, {programs} programs x {lanes} lanes): "
            f"first call {ts[0]:.4f}s, warm {np.median(ts[1:]):.4f}s")


def four_card_phase(data: bytes) -> None:
    import jax

    from libdeflate_rsx_tpu.parallel import (ShardedCompressor,
                                             ShardedDecompressor,
                                             stream_mesh)
    from libdeflate_rsx_tpu.parallel import shard
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    assert len(jax.devices()) == 4, jax.devices()
    mesh = stream_mesh()
    for tier in ("static", "dynamic"):
        sc = ShardedCompressor(mesh, tier=tier)
        out, t = timed(lambda: sc.compress(data, format="gzip"))
        assert gzip.decompress(out) == data, f"{tier} gzip"
        raw = sc.compress(data, format="deflate")
        assert zlib.decompress(raw, -15) == data, f"{tier} deflate"
        log(f"ShardedCompressor {tier}: gzip + deflate byte-exact, "
            f"ratio {len(data) / len(out):.4f}, gzip first call {t:.2f}s")
    slices, objs = gzip_slices(data)
    streams = [zlib.compress(s, 6)[2:-4] for s in slices]
    for resolve in ("host", "device"):
        dec = ShardedDecompressor(mesh, resolve=resolve)
        got, t = timed(lambda: dec.decompress_batch(streams))
        assert got == slices, f"ShardedDecompressor resolve={resolve}"
        log(f"ShardedDecompressor resolve={resolve}: {len(streams)} "
            f"streams byte-exact, first call {t:.2f}s")
    # every card decodes its own shard of the streams
    programs, lanes = it.layout(len(streams), 4)
    inbits, words, _ = it.pack_streams(streams, programs * lanes)
    fn = shard._sharded_pass1(mesh, programs // 4, lanes, 72 * 1024,
                              it.IN_CAP, it.OUT_CAP, False)
    tok, stats = fn(jax.device_put(inbits, shard.NamedSharding(
        mesh, shard.P(shard.AXIS))), jax.device_put(
            words, shard.NamedSharding(mesh, shard.P(shard.AXIS))))
    shards = tok.addressable_shards
    devs = sorted(str(s.device) for s in shards)
    assert len(set(devs)) == 4, devs
    assert all(s.data.shape == (72 * 1024, programs * lanes // 4)
               for s in shards)
    jax.block_until_ready(stats)
    log(f"sharded pass 1: one token shard of {shards[0].data.shape} on "
        f"each of {devs}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args()

    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          os.path.join(ROOT, ".jax_cache"))
    sys.path.insert(0, ROOT)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a CUDA GPU; JAX found "
                 f"{dev.platform!r}")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    from libdeflate_rsx_tpu.native import get_ext, get_lib
    log(f"native engine: {get_lib()._name}, {get_ext().__name__}")

    data, t = timed(corpus)
    log(f"corpus {len(data)} bytes ({t:.1f}s)")
    if args.four_cards:
        four_card_phase(data)
    else:
        compress_phase(data)
        l6_phase_times(data)
        decompress_phase(data)
        kernel_phase(data)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
