"""Lockstep two-pass decoder (ops/pallas/inflate_tokens.py).

Pass 1 runs in the Pallas interpreter on the CPU test backend; pass 2 is
the native C resolver. Differential oracle: CPython zlib produces every
stream (the reference's libdeflater-oracle pattern, SURVEY.md section
4). Every test shares one compiled variant (one program, MAX_STEPS
steps, the 64 KiB caps) unless it tests the variant choice itself.
"""

import random
import zlib

import numpy as np
import pytest

from tests.conftest import make_corpus

MAX_STEPS = 16384


def _run(streams, **kw):
    from libdeflate_rsx_tpu.ops.pallas.inflate_tokens import (
        inflate_device_tokens)

    kw.setdefault("max_steps", MAX_STEPS)
    return inflate_device_tokens(streams, interpret=True, **kw)


def _z(data, level=6):
    return zlib.compress(data, level)[2:-4]


def test_all_levels_all_kinds():
    cases = []
    for lvl in (0, 1, 6, 9):
        for kind in ("text", "random", "pattern"):
            cases.append(make_corpus(kind, 350 + 37 * lvl, seed=lvl))
    streams = [_z(d, lvl) for lvl, d in
               zip([0, 0, 0, 1, 1, 1, 6, 6, 6, 9, 9, 9], cases)]
    assert _run(streams) == cases


def test_multiblock_and_tiny():
    d = make_corpus("text", 400, seed=3)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    multi = (co.compress(d[:200]) + co.flush(zlib.Z_FULL_FLUSH)
             + co.compress(d[200:]) + co.flush())
    res = _run([multi, _z(b"x"), _z(b"")])
    assert res[0] == d
    assert res[1] == b"x"
    assert res[2] == b""


def test_small_offsets_and_rle():
    datas = []
    for off in (1, 2, 3, 4, 7):
        r = random.Random(off)
        base = bytes(r.randrange(256) for _ in range(off))
        datas.append((base * (600 // off + 1))[:600])
    datas.append(b"\x00" * 700)
    assert _run([_z(d) for d in datas]) == datas


def test_garbage_and_truncation_yield_none():
    r = random.Random(11)
    good = make_corpus("text", 300, seed=1)
    streams = [
        bytes(r.randrange(256) for _ in range(60)),
        _z(good)[:25],
        b"\x07\x00",
        _z(good),
    ]
    res = _run(streams)
    assert res[3] == good
    for got in res[:3]:
        assert got is None or isinstance(got, bytes)  # never raises
    assert res[1] is None  # truncated must not "succeed"


def test_batch_larger_than_one_group():
    datas = [make_corpus("pattern", 120 + 7 * i, seed=i)
             for i in range(140)]  # one program per stream
    assert _run([_z(d, 1) for d in datas], max_steps=2048) == datas


def test_stored_block_roundtrip():
    d = make_corpus("random", 500, seed=5)
    assert _run([_z(d, 0)]) == [d]


def test_output_exactly_at_cap():
    """A stream whose output is exactly out_cap decodes; one byte more
    must yield None, never a truncated or corrupted result."""
    from libdeflate_rsx_tpu.ops.pallas.inflate_tokens import OUT_CAP

    r = random.Random(5)
    base = bytes(r.randrange(256) for _ in range(100))
    datas = [(base * (OUT_CAP // 100 + 1))[:n]
             for n in (OUT_CAP - 1, OUT_CAP, OUT_CAP + 1)]
    got = _run([_z(d) for d in datas])
    assert got[0] == datas[0]
    assert got[1] == datas[1]
    assert got[2] is None


def test_tokens_match_numpy_resolver():
    """Pass-1 token columns resolve to the zlib oracle's bytes through
    the numpy reference resolver as well as the C resolver."""
    from libdeflate_rsx_tpu.ops.pallas.inflate_tokens import (
        decode_tokens_device)
    from libdeflate_rsx_tpu.ops.tokens import resolve_tokens_np

    datas = [make_corpus("text", 2500, seed=4), bytes(900),
             make_corpus("random", 300, seed=6)]
    jobs = decode_tokens_device([_z(d) for d in datas],
                                max_steps=MAX_STEPS, interpret=True)
    for (col, outlen), d in zip(jobs, datas):
        assert outlen == len(d)
        assert resolve_tokens_np(col, outlen) == d


# --------------------------------------------------------- wrapper (CPU)
@pytest.mark.parametrize("n,programs,lanes", [
    (1, 1, 1), (7, 8, 1), (16, 16, 1), (17, 32, 1), (260, 512, 1),
    (4096, 4096, 1), (5000, 4096, 2), (8288, 4096, 4),
    (200000, 8192, 32)])
def test_layout_streams_per_program(n, programs, lanes):
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    assert it.layout(n) == (programs, lanes)
    assert programs & (programs - 1) == 0            # power of two
    assert programs * lanes >= n
    assert lanes <= it.MAX_LANES


@pytest.mark.parametrize("n,mesh", [(1, 8), (9, 8), (300, 8), (5, 4),
                                    (40000, 4)])
def test_layout_shards_evenly(n, mesh):
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    programs, lanes = it.layout(n, mesh)
    assert programs % mesh == 0
    assert programs * lanes >= n
    assert programs // mesh <= it.MAX_PROGRAMS


@pytest.mark.parametrize("n,npad,ncols", [
    (1, 1, 1), (3, 8, 3), (9, 64, 16), (259, 512, 320), (256, 256, 256),
    (4097, 8192, 5120)])
def test_resolve_columns_skip_padding(n, npad, ncols):
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    assert it.resolve_columns(n, npad) == ncols


def test_resolve_tokens_device_reads_real_columns():
    """The device resolver covers the real streams rounded up to an
    eighth of the layout; a padding column past that is never read."""
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it
    from libdeflate_rsx_tpu.ops.tokens import KIND_LIT, KIND_SHIFT

    tok = np.zeros((4, 64), np.int32)
    for i in range(9):
        tok[:i % 4 + 1, i] = (KIND_LIT << KIND_SHIFT) | (65 + i)
    tok[:, 40] = (KIND_LIT << KIND_SHIFT) | 7      # beyond column 16
    out, outlen, ok = it.resolve_tokens_device(tok, 9, 64)
    assert out.shape == (16, 64) and outlen.shape == (16,)
    assert np.asarray(ok).all()
    for i in range(9):
        assert np.asarray(out)[i, :i % 4 + 1].tobytes() == \
            bytes([65 + i]) * (i % 4 + 1)
        assert int(outlen[i]) == i % 4 + 1


def test_pack_streams_flat_layout():
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    streams = [b"\x01\x02\x03\x04\x05", b"", b"z" * 70000, b"abcd" * 3]
    inbits, words, ok = it.pack_streams(streams, 8, in_cap=65536)
    assert words.shape == (8, 65536 // 4 + 2) and words.dtype == np.int32
    assert inbits.tolist() == [40, 0, 0, 96, 0, 0, 0, 0]
    assert ok == [True, False, False, True]
    assert words[0, 0] == int.from_bytes(b"\x01\x02\x03\x04", "little")
    assert words[0, 1] == 5                     # zero padded
    assert words[3, :3].tobytes() == b"abcd" * 3
    assert not words[1].any() and not words[2].any()


def test_static_row_tables():
    """The shared row: limits padded to 16 columns with an unused huge
    column 0, the precode order and its inverse padded to 32 entries,
    and canonical tables that decode every static code back to its
    symbol (an independent bit-by-bit canonical decode)."""
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    row = it._STATIC_ROW
    assert row.shape == (it.ROW,)
    order = row[it.T_ORDER:it.T_ORDER + 32]
    inv = row[it.T_INV_ORDER:it.T_INV_ORDER + 32]
    assert order[:19].tolist() == it.CLCL_ORDER.tolist()
    assert not order[19:].any() and not inv[19:].any()
    assert all(order[inv[s]] == s for s in range(19))
    lens = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
    lim = row[it.T_LL_LIM:it.T_LL_LIM + 16]
    fb = row[it.T_LL_FB:it.T_LL_FB + 16]
    perm = row[it.T_LL_PERM:it.T_LL_PERM + 288]
    assert lim[0] == 1 << 29
    code, nxt = 0, {}
    for ln in range(1, 16):
        for s in range(288):
            if lens[s] == ln:
                nxt[s] = (code, ln)
                code += 1
        code <<= 1
    for s, (c, ln) in nxt.items():
        v15 = c << (15 - ln)                    # MSB-aligned code
        length = 1 + int(np.sum(v15 >= lim))
        assert length == ln
        assert perm[(v15 >> (15 - ln)) + fb[ln]] == s


def test_canonical_tables_match_dynamic_lengths():
    """canonical_tables (the host mirror of the in-kernel build) on an
    uneven length set: limits are the running Kraft sums."""
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    lens = [2, 1, 3, 4, 0, 4]
    lim, fb, perm = it.canonical_tables(lens, 8)
    assert perm[:5].tolist() == [1, 0, 2, 3, 5]
    assert lim[1] == 1 << 14
    assert lim[2] == (1 << 14) + (1 << 13)
    assert lim[4] == 1 << 15                    # complete code
    assert fb[1] == 0 and fb[2] == 1 - 2


def test_kernel_refuses_cpu_without_interpret():
    """Interpret mode is never chosen from the backend: on the CPU the
    compiled kernel raises instead of quietly interpreting."""
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    with pytest.raises(RuntimeError, match="CUDA GPU"):
        it._jit_pass1(1, 1, 1024)


def test_step_and_cap_buckets():
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it

    assert it.steps_for_caps([600]) == 2048
    assert it.steps_for_caps([65536]) == 72 * 1024
    assert it.steps_for_caps([1 << 20]) == 1088 * 1024
    assert it.cap_bucket([600, 3000]) == 16384
    assert it.in_cap_bucket([b"x" * 70000]) == 262144
