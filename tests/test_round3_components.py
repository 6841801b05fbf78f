"""Round-3 component coverage: token resolvers, resumable C inflater,
sharded decode, multi-host global container (single-process leg).

The 2-process multi-host leg lives in test_multihost.py; the lockstep
kernel's differential suite in test_inflate_tokens.py.
"""

import random
import zlib

import numpy as np
import pytest

from tests.conftest import make_corpus


# ---------------------------------------------------------- resolvers
def _synthetic_tokens(n_out: int, seed: int):
    from libdeflate_rsx_tpu.ops.tokens import (
        KIND_LIT, KIND_MATCH, KIND_SHIFT)

    r = random.Random(seed)
    toks, out = [], bytearray()
    while len(out) < n_out:
        if out and r.random() < 0.55:
            dist = r.randrange(1, min(len(out), 32768) + 1)
            length = r.randrange(3, 259)
            for _ in range(length):
                out.append(out[-dist])
            toks.append((KIND_MATCH << KIND_SHIFT) | (length - 3)
                        | ((dist - 1) << 8))
        else:
            b = r.randrange(256)
            out.append(b)
            toks.append((KIND_LIT << KIND_SHIFT) | b)
        if r.random() < 0.15:
            toks.append(0)          # NOP stall slots
    return np.asarray(toks, np.int32), bytes(out)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_c_resolver_matches_numpy_oracle(seed):
    from libdeflate_rsx_tpu.native.host import native_resolve_tokens
    from libdeflate_rsx_tpu.ops.tokens import resolve_tokens_np

    toks, expect = _synthetic_tokens(4000, seed)
    cap = len(expect) + 512
    assert resolve_tokens_np(toks, cap) == expect
    assert native_resolve_tokens(toks, cap) == expect


def test_resolver_rejects_bad_tokens():
    from libdeflate_rsx_tpu.native.host import native_resolve_tokens
    from libdeflate_rsx_tpu.ops.tokens import (
        KIND_LIT, KIND_MATCH, KIND_SHIFT, resolve_tokens_np)

    bad_dist = np.asarray(
        [(KIND_MATCH << KIND_SHIFT) | 0 | ((7 - 1) << 8)], np.int32)
    assert resolve_tokens_np(bad_dist, 64) is None
    assert native_resolve_tokens(bad_dist, 64) is None
    overflow = np.asarray([(KIND_LIT << KIND_SHIFT) | 65] * 10, np.int32)
    assert native_resolve_tokens(overflow, 5) is None


# ------------------------------------------------ resumable C inflater
def _dribble_decode(comp: bytes, insz: int, outsz: int) -> bytes:
    from libdeflate_rsx_tpu.native.host import CInflater
    from libdeflate_rsx_tpu.utils.errors import DecompressStatus

    inf = CInflater()
    out = bytearray()
    pos = 0
    pend = b""
    while not inf.finished:
        st, used = inf.step(pend, out, len(out) + outsz)
        pend = pend[used:]
        if st == DecompressStatus.SHORT_INPUT:
            assert pos < len(comp), "EOF mid-stream"
            pend += comp[pos:pos + insz]
            pos += insz
    return bytes(out)


@pytest.mark.parametrize("insz,outsz", [(1, 17), (7, 1000), (997, 65536)])
def test_cinflater_dribble_protocol(insz, outsz):
    data = (make_corpus("text", 30_000, seed=4)
            + make_corpus("random", 5_000, seed=5)
            + b"\x00" * 4_000)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = (co.compress(data[:15_000]) + co.flush(zlib.Z_FULL_FLUSH)
            + co.compress(data[15_000:]) + co.flush())
    assert _dribble_decode(comp, insz, outsz) == data


def test_cinflater_stored_blocks_and_bad_data():
    from libdeflate_rsx_tpu.native.host import CInflater
    from libdeflate_rsx_tpu.utils.errors import BadDataError

    data = make_corpus("random", 20_000, seed=6)
    assert _dribble_decode(zlib.compress(data, 0)[2:-4], 113, 4096) == data

    inf = CInflater()
    with pytest.raises(BadDataError):
        # BTYPE=11 reserved
        inf.step(b"\x07\x00\x00", bytearray(), 64)


# ------------------------------------------------------ sharded decode
def test_sharded_decompressor_roundtrip():
    from libdeflate_rsx_tpu.parallel import ShardedDecompressor, stream_mesh

    # small streams: this test pins the shard_map wiring + per-item
    # isolation, not kernel internals (test_inflate_tokens.py covers
    # sizes and block kinds)
    datas = [make_corpus("pattern", 90 + 17 * i, seed=i)
             for i in range(8)] + [make_corpus("pattern", 400, seed=8)]
    streams = [zlib.compress(d, 6)[2:-4] for d in datas]
    streams.append(b"\x99garbage!")
    dec = ShardedDecompressor(stream_mesh(), max_steps=1024, interpret=True)
    got = dec.decompress_batch(streams)
    assert got[:9] == datas
    assert got[9] is None


# ----------------------------------------- multi-host global container
def test_compress_global_single_process():
    import gzip

    from libdeflate_rsx_tpu.parallel import multihost as mh

    data = make_corpus("text", 200_000, seed=7)
    out = mh.compress_global(data, "gzip", block_size=65536)
    assert gzip.decompress(out) == data
    z = mh.compress_global(data, "zlib", block_size=65536)
    assert zlib.decompress(z) == data
    raw = mh.compress_global(data, "deflate", block_size=65536)
    assert zlib.decompress(raw, -15) == data
    assert gzip.decompress(mh.compress_global(b"", "gzip")) == b""


def test_batch_decompressor_device_routes_lockstep():
    """BatchDecompressor(use_device=True) rides the lockstep decoder
    (bucketed step budget) and stays byte-exact with per-item
    isolation."""
    from libdeflate_rsx_tpu.batch import BatchDecompressor

    datas = [make_corpus("pattern", 80 + 9 * i, seed=i)
             for i in range(8)]
    streams = [zlib.compress(d, 6)[2:-4] for d in datas]
    streams.append(b"\x01\x02junk")
    out = BatchDecompressor(use_device=True, interpret=True).decompress_batch(
        streams, [600 for _ in streams])
    assert out[:8] == datas
    assert out[8] is None


# --------------------------------------- dyn header self-consistency
def test_dyn_tables_header_matches_tables():
    """The device dynamic tier's host step (dyn_tables_c) must emit a
    header whose RLE-decoded code lengths are Kraft-complete and agree
    with the code tables it hands the device emitter. Regression for a
    class of bug where an entry point skipped table init and serialized
    garbage codes (caught by the device fuzz; reduced here without the
    device pipeline so it runs in milliseconds)."""
    import random

    import numpy as np

    from libdeflate_rsx_tpu.native import dyn_tables_native

    order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2,
             14, 1, 15]

    def decode_header(hdr_bytes):
        bits = np.unpackbits(np.frombuffer(hdr_bytes, np.uint8),
                             bitorder="little")
        pos = 0

        def get(n):
            nonlocal pos
            v = int(bits[pos:pos + n] @ (1 << np.arange(n)))
            pos += n
            return v

        get(3)  # BFINAL | BTYPE
        hlit, hdist, hclen = get(5) + 257, get(5) + 1, get(4) + 4
        pre = [0] * 19
        for k in range(hclen):
            pre[order[k]] = get(3)
        codes = {}
        code = 0
        for le in range(1, 8):
            for s in range(19):
                if pre[s] == le:
                    codes[(le, code)] = s
                    code += 1
            code <<= 1

        def dp():
            le, c = 0, 0
            while True:
                c = (c << 1) | get(1)
                le += 1
                if (le, c) in codes:
                    return codes[(le, c)]
                assert le <= 7, "invalid precode bits"

        lens = []
        while len(lens) < hlit + hdist:
            s = dp()
            if s < 16:
                lens.append(s)
            elif s == 16:
                lens += [lens[-1]] * (3 + get(2))
            elif s == 17:
                lens += [0] * (3 + get(3))
            else:
                lens += [0] * (11 + get(7))
        assert len(lens) == hlit + hdist
        return lens[:hlit], lens[hlit:]

    rng = random.Random(9)
    for _ in range(60):
        used_ll = rng.randint(1, 286)
        used_of = rng.randint(0, 30)
        llf = np.zeros(288, np.uint32)
        off = np.zeros(30, np.uint32)
        for i in rng.sample(range(286), used_ll):
            llf[i] = rng.choice([1, 2, 65535, 2 ** rng.randint(0, 20)])
        for i in rng.sample(range(30), used_of):
            off[i] = rng.choice([1, 2, 65535, 2 ** rng.randint(0, 20)])
        ll_tab, of_tab, hdr, bits = dyn_tables_native(llf, off, True)
        ll, of = decode_header(hdr)
        kraft_ll = sum(2.0 ** -l for l in ll if l)
        assert abs(kraft_ll - 1) < 1e-12, "litlen set not complete"
        nz_of = [l for l in of if l]
        if len(nz_of) > 1:
            assert abs(sum(2.0 ** -l for l in nz_of) - 1) < 1e-12
        # header lens must match the emit tables (code|len<<16)
        for s, le in enumerate(ll):
            assert (ll_tab[s] >> 16) == le
        for s, le in enumerate(of):
            assert (of_tab[s] >> 16) == le
