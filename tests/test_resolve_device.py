"""Device (XLA) LZ copy-resolution pass — differential tests.

Oracle: ops.tokens.resolve_tokens_np (the slow per-token reference
resolver). The device resolver (ops/resolve.py) must agree byte-exactly
on valid token columns and flag the same invalid ones, including the
pointer-doubling worst cases (offset-1 RLE runs = maximum chain depth)
that correspond to the reference's specialized copy kernels
(reference src/decompress/x86.rs:2030-2190).
"""

import numpy as np
import pytest

from libdeflate_rsx_tpu.ops.tokens import (
    KIND_LIT,
    KIND_MATCH,
    KIND_NOP,
    KIND_SHIFT,
    resolve_tokens_np,
)
from libdeflate_rsx_tpu.ops.resolve import (
    resolve_batch_jax,
    resolve_tokens_device,
)


def lit(b):
    return (KIND_LIT << KIND_SHIFT) | (b & 0xFF)


def match(length, dist):
    assert 3 <= length <= 258 and 1 <= dist <= 32768
    return (KIND_MATCH << KIND_SHIFT) | ((dist - 1) << 8) | (length - 3)


NOP = KIND_NOP << KIND_SHIFT


def col(tokens, T):
    a = np.full(T, NOP, np.int32)
    a[: len(tokens)] = np.array(tokens, np.int32)
    return a


def run_batch(cols, out_cap):
    toks = np.stack(cols)
    return resolve_tokens_device(toks, out_cap)


def test_literals_only():
    c = col([lit(i & 0xFF) for i in range(40)], 64)
    (got,) = run_batch([c], 128)
    assert got == bytes(i & 0xFF for i in range(40))


def test_simple_copy_and_overlap():
    cases = [
        [lit(65), lit(66), lit(67), match(5, 3)],        # overlap d<l
        [lit(1), match(258, 1)],                          # RLE depth 258
        [lit(7), lit(8), match(4, 2), match(10, 6)],
        [lit(9)] * 30 + [match(20, 30), match(17, 5)],
    ]
    T = 300
    cols = [col(c, T) for c in cases]
    outs = run_batch(cols, 512)
    for c, got in zip(cols, outs):
        want = resolve_tokens_np(c, 512)
        assert got == want


def test_nops_interleaved():
    c = col([lit(10), NOP, NOP, lit(11), NOP, match(3, 2), NOP], 32)
    (got,) = run_batch([c], 64)
    assert got == resolve_tokens_np(c, 64)


@pytest.mark.parametrize("dist", [1, 2, 3, 4, 7, 8, 18, 31, 32, 64])
def test_per_offset_patterns(dist):
    """Analog of the reference's per-offset kernel tests
    (reference tests/offset_tests.rs): periodic pattern of period
    `dist` produced by one long overlapping copy chain."""
    toks = [lit((i * 37 + dist) & 0xFF) for i in range(dist)]
    toks += [match(258, dist)] * 6 + [match(17, dist)]
    c = col(toks, len(toks) + 8)
    (got,) = run_batch([c], 4096)
    want = resolve_tokens_np(c, 4096)
    assert got == want
    # confirm it is actually periodic
    assert got[dist : 2 * dist] == got[:dist]


def test_deep_chain_through_mixed_tokens():
    """Chains through several generations of copies-of-copies."""
    rng = np.random.default_rng(11)
    toks = [lit(int(b)) for b in rng.integers(0, 256, 64)]
    pos = 64
    for _ in range(200):
        length = int(rng.integers(3, 40))
        dist = int(rng.integers(1, pos))
        dist = min(dist, 32768)
        toks.append(match(length, dist))
        pos += length
        if rng.random() < 0.3:
            toks.append(lit(int(rng.integers(0, 256))))
            pos += 1
    c = col(toks, len(toks))
    cap = pos + 64
    (got,) = run_batch([c], cap)
    want = resolve_tokens_np(c, cap)
    assert got == want


def test_batch_mixed_valid_invalid():
    good = col([lit(1), lit(2), match(3, 2)], 16)
    bad_dist = col([lit(1), match(3, 2)], 16)          # dist 2 > pos 1
    overflow = col([lit(0)] * 10 + [match(258, 1)] * 3, 16)  # > cap
    outs = run_batch([good, bad_dist, overflow], 20)
    assert outs[0] == resolve_tokens_np(good, 20)
    assert outs[1] is None and resolve_tokens_np(bad_dist, 20) is None
    assert outs[2] is None and resolve_tokens_np(overflow, 20) is None


def test_exact_cap_fit():
    c = col([lit(5)] * 4 + [match(12, 4)], 8)
    (got,) = run_batch([c], 16)   # outlen 16 == cap
    assert got == resolve_tokens_np(c, 16)
    assert len(got) == 16


def test_random_differential_many_streams():
    """Many random valid streams at once (vmapped batch axis)."""
    rng = np.random.default_rng(3)
    cols, cap = [], 2048
    for _ in range(16):
        toks, pos = [], 0
        while pos < cap - 300 and len(toks) < 900:
            if pos < 4 or rng.random() < 0.45:
                toks.append(lit(int(rng.integers(0, 256))))
                pos += 1
            else:
                length = int(rng.integers(3, 120))
                dist = int(rng.integers(1, pos + 1))
                toks.append(match(length, dist))
                pos += length
        cols.append(col(toks, 1024))
    outs = run_batch(cols, cap)
    for c, got in zip(cols, outs):
        assert got == resolve_tokens_np(c, cap)


def test_agrees_with_pass1_tokens_end_to_end():
    """Tokens from the real pass-1 kernel (Pallas interpreter on the
    CPU) resolve on the device to the zlib oracle's bytes."""
    import zlib

    from libdeflate_rsx_tpu.ops.pallas.inflate_tokens import (
        decode_tokens_device,
    )

    rng = np.random.default_rng(7)
    base = bytes(rng.integers(97, 123, 3000).astype(np.uint8))
    datas = [zlib.compress(base * 3, 6)[2:-4],
             zlib.compress(bytes(5000), 1)[2:-4]]
    # shares the suite's pass-1 compile (test_inflate_tokens.MAX_STEPS)
    jobs = decode_tokens_device(datas, max_steps=16384, interpret=True)
    cols = [c for c, _ in jobs]
    assert all(c is not None for c in cols)
    T = max(len(c) for c in cols)
    cols = [col(list(c), T) for c in cols]
    outs = run_batch(cols, 16384)
    assert outs[0] == base * 3
    assert outs[1] == bytes(5000)


def test_inflate_device_fused_end_to_end():
    """Both passes on device: pass-1 token kernel -> XLA resolver."""
    import zlib

    from libdeflate_rsx_tpu.ops.pallas.inflate_tokens import (
        inflate_device_fused,
    )

    rng = np.random.default_rng(21)
    datas = [
        (rng.integers(97, 123, 50, dtype=np.uint8).tobytes() * 20)[:900],
        bytes(600),
        rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
    ]
    streams = [zlib.compress(d, 6)[2:-4] for d in datas]
    streams.append(b"\xff\x07bad")          # invalid -> None
    got = inflate_device_fused(streams, max_steps=2048, out_cap=2048,
                               interpret=True)
    assert got[:3] == datas
    assert got[3] is None


def test_batch_decompressor_device_resolve_routing():
    """BatchDecompressor(use_device=True, resolve='device') routes
    through inflate_device_fused and stays byte-exact."""
    import zlib

    from libdeflate_rsx_tpu.batch import BatchDecompressor

    rng = np.random.default_rng(9)
    datas = [(rng.integers(97, 123, 30 + i, dtype=np.uint8).tobytes()
              * 10)[: 200 + 20 * i] for i in range(8)]
    streams = [zlib.compress(d, 6)[2:-4] for d in datas]
    out = BatchDecompressor(use_device=True, resolve="device",
                            interpret=True).decompress_batch(
        streams, [600] * len(streams))
    assert out == datas


def test_sharded_decompressor_device_resolve():
    """ShardedDecompressor(resolve='device'): pass 2 runs as the
    sharded XLA pass; byte-exact with per-item isolation."""
    import zlib

    from libdeflate_rsx_tpu.parallel import (
        ShardedDecompressor,
        stream_mesh,
    )

    rng = np.random.default_rng(5)
    datas = [
        (rng.integers(65, 91, 40 + i, dtype=np.uint8).tobytes()
         * 12)[: 300 + 40 * i]
        for i in range(5)
    ]
    streams = [zlib.compress(d, 6)[2:-4] for d in datas]
    streams.append(b"\x99nope")
    dec = ShardedDecompressor(stream_mesh(), max_steps=1024,
                              resolve="device", out_cap=2048,
                              interpret=True)
    got = dec.decompress_batch(streams)
    assert got[:5] == datas
    assert got[5] is None


def test_jit_under_vmap_shard_shapes():
    """resolve_batch_jax must trace cleanly under jit with a leading
    batch axis (the shard_map path maps it over mesh shards)."""
    import jax
    import jax.numpy as jnp

    c = col([lit(3), lit(4), match(6, 2)], 8)
    toks = jnp.asarray(np.stack([c] * 4), jnp.int32)
    out, outlen, ok = jax.jit(
        lambda t: resolve_batch_jax(t, 32))(toks)
    assert out.shape == (4, 32) and bool(ok.all())
    assert int(outlen[0]) == 8
    want = resolve_tokens_np(c, 32)
    assert bytes(np.asarray(out[0][: int(outlen[0])])) == want
