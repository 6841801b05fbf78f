"""Device dynamic-Huffman tier tests (CPU backend): wire-format validity
via the zlib oracle, ratio gain over the static tier, header/table
construction parity between the native and Python builders, batch wiring."""

import zlib

import numpy as np
import pytest

from libdeflate_rsx_tpu.models.greedy_dynamic import deflate_device_dynamic
from libdeflate_rsx_tpu.models.greedy_static import deflate_device_static
from tests.conftest import make_corpus


def raw_inflate(b):
    return zlib.decompress(b, wbits=-15)


@pytest.mark.parametrize("kind,size", [
    ("text", 1000), ("text", 70000), ("pattern", 150000), ("zeros", 100000),
    ("random", 30000), ("text", 0), ("text", 1), ("periodic:7", 50000),
    ("text", 65536), ("text", 65537), ("pattern", 120000),
])
def test_device_dynamic_roundtrip(kind, size):
    data = make_corpus(kind, size)
    comp = deflate_device_dynamic(data)
    assert raw_inflate(comp) == data


def test_dynamic_beats_static_on_text():
    """The whole point of the tier: per-block code tables shrink
    entropy-skewed data (reference src/compress/mod.rs:1775-1883)."""
    data = make_corpus("text", 400000)
    dyn = deflate_device_dynamic(data)
    stat = deflate_device_static(data)
    assert raw_inflate(dyn) == data
    assert len(dyn) < 0.9 * len(stat)


def test_dynamic_incompressible_falls_back_stored():
    data = make_corpus("random", 80000)
    comp = deflate_device_dynamic(data)
    assert raw_inflate(comp) == data
    # stored fallback: ~5 B per stored sub-block across the 64 KiB
    # device blocks, never entropy-coded expansion
    nblocks = -(-len(data) // 65536)
    assert len(comp) <= len(data) + 5 * (nblocks + len(data) // 65535 + 1)


def test_sync_joins_are_byte_aligned_blocks():
    """Multi-block streams must decode as one stream AND block-by-block
    (SYNC joins end each non-final block byte-aligned)."""
    data = make_corpus("text", 3 * 65536 + 17)
    comp = deflate_device_dynamic(data)
    assert raw_inflate(comp) == data
    d = zlib.decompressobj(wbits=-15)
    out = d.decompress(comp)
    assert out == data


def test_native_and_python_table_builders_agree():
    from libdeflate_rsx_tpu.native import dyn_tables_native
    from libdeflate_rsx_tpu.ops.encode_dynamic import _build_tables_py

    rng = np.random.default_rng(3)
    for trial in range(8):
        llh = rng.integers(0, 500, 288).astype(np.uint32)
        llh[rng.integers(0, 288, 150)] = 0        # sparse alphabets
        ofh = rng.integers(0, 200, 30).astype(np.uint32)
        ofh[rng.integers(0, 30, 20)] = 0
        final = bool(trial & 1)
        nat = dyn_tables_native(llh, ofh, final)
        if nat is None:
            pytest.skip("no native library")
        py = _build_tables_py(llh, ofh, final)
        # code LENGTH vectors must agree (both are optimal package-merge);
        # serialized headers must be bit-identical
        assert np.array_equal(nat[0] >> 16, py[0] >> 16), trial
        assert np.array_equal(nat[1] >> 16, py[1] >> 16), trial
        assert nat[2] == py[2] and nat[3] == py[3], trial


def test_batch_dynamic_level_roundtrip():
    from libdeflate_rsx_tpu.batch import BatchCompressor
    datas = [make_corpus("text", 30000, seed=i) for i in range(4)]
    bc = BatchCompressor(level=6, use_device=True)
    outs = bc.compress_batch(datas)
    for d, o in zip(datas, outs):
        assert raw_inflate(o) == d


def test_dynamic_gzip_container_device():
    from libdeflate_rsx_tpu.batch import BatchCompressor
    import gzip as gz
    data = make_corpus("text", 50000)
    out = BatchCompressor(level=6, format="gzip",
                          use_device=True).compress_batch([data])[0]
    assert gz.decompress(out) == data


def test_auto_offload_ratio_contract():
    """AUTO mode (use_device=None) must not silently produce a worse
    ratio than the requested level: the calibration gate compares the
    device tier against the host engine once and routes the batch to
    whichever honors the level's ratio class (within RATIO_SLACK)."""
    from libdeflate_rsx_tpu import batch as batch_mod
    from libdeflate_rsx_tpu.batch import BatchCompressor
    from libdeflate_rsx_tpu.engine import compress_raw
    from libdeflate_rsx_tpu.models.portable.deflate import Flush

    datas = [make_corpus("text", 40000, seed=i) for i in range(3)]
    bc = BatchCompressor(level=6)
    # pretend JAX runs on a GPU so auto mode actually considers the
    # device path; the ratio gate is what's under test
    old = batch_mod._gpu_backend
    batch_mod._gpu_backend = lambda: True
    try:
        outs = bc.compress_batch(datas)
    finally:
        batch_mod._gpu_backend = old
    for d, o in zip(datas, outs):
        assert raw_inflate(o) == d
        host = compress_raw(d, 6, Flush.FINISH)
        assert len(o) <= len(host) * BatchCompressor.RATIO_SLACK


def test_auto_offload_calibration_cached():
    from libdeflate_rsx_tpu.batch import BatchCompressor
    bc = BatchCompressor(level=6)
    assert bc._ratio_ok is None
    got = bc._ratio_calibrate([make_corpus("text", 20000)])
    assert bc._ratio_ok is got
    # second call must not re-run the (expensive) calibration
    bc._ratio_ok = not got
    assert bc._ratio_calibrate([b"x" * 20000]) == (not got)


# -- L6 ratio tier (strided ladder + history carry) -------------------------

@pytest.mark.parametrize("kind,size", [
    ("text", 1000), ("text", 70000), ("pattern", 150000),
    ("zeros", 100000), ("random", 30000), ("text", 0), ("text", 1),
    ("periodic:7", 50000), ("text", 65537),
])
def test_device_l6_roundtrip(kind, size):
    from libdeflate_rsx_tpu.models.greedy_dynamic import deflate_device_l6
    data = make_corpus(kind, size)
    assert raw_inflate(deflate_device_l6(data, 16384)) == data


def test_l6_history_carry_improves_ratio():
    """Blocks see the previous 32 KiB: a 20 KiB-period repeat spanning
    blocks must compress far better than independent blocks would."""
    from libdeflate_rsx_tpu.models.greedy_dynamic import (
        deflate_device_dynamic, deflate_device_l6)
    base = make_corpus("text", 20000)
    data = base * 6                      # 120 KB, period 20 KB
    l6 = deflate_device_l6(data, 16384)
    nohist = deflate_device_dynamic(data, 16384)
    assert raw_inflate(l6) == data
    assert len(l6) < 0.5 * len(nohist)


def test_l6_first_block_no_false_history():
    """The first block has no history: zero padding in the prefix must
    never become a match source (hist_start gating)."""
    from libdeflate_rsx_tpu.models.greedy_dynamic import deflate_device_l6
    data = b"\x00" * 50000               # zeros would match the padding
    comp = deflate_device_l6(data, 16384)
    assert raw_inflate(comp) == data


def test_l6_beats_fast_dynamic_on_text():
    from libdeflate_rsx_tpu.models.greedy_dynamic import (
        deflate_device_dynamic, deflate_device_l6)
    data = make_corpus("text", 300000)
    l6 = deflate_device_l6(data)
    fast = deflate_device_dynamic(data)
    assert raw_inflate(l6) == data
    assert len(l6) < 0.93 * len(fast)


def test_l6_many_batched_matches_per_item():
    """deflate_device_l6_many: one batched launch, per-item output
    identical to per-item deflate_device_l6 (history must not cross
    item boundaries)."""
    from libdeflate_rsx_tpu.models.greedy_dynamic import (
        deflate_device_l6, deflate_device_l6_many)
    datas = [make_corpus("text", 40000, seed=i) for i in range(3)]
    datas.append(make_corpus("pattern", 100000))
    many = deflate_device_l6_many(datas, 16384)
    for d, o in zip(datas, many):
        assert raw_inflate(o) == d
        assert o == deflate_device_l6(d, 16384)


def test_batch_level6_uses_ratio_tier():
    """Round-3 review item: BatchCompressor at level >= 6 must route to
    the L6 ratio tier (not the fast dynamic tier the calibration gate
    rejects). Explicit use_device=True documents the remaining ratio
    trade; the batched output must match the per-item L6 tier."""
    from libdeflate_rsx_tpu.batch import BatchCompressor
    from libdeflate_rsx_tpu.models.greedy_dynamic import (
        deflate_device_dynamic, deflate_device_l6)
    datas = [make_corpus("text", 50000, seed=i) for i in range(2)]
    outs = BatchCompressor(level=6, use_device=True).compress_batch(datas)
    for d, o in zip(datas, outs):
        assert raw_inflate(o) == d
        assert o == deflate_device_l6(d)          # the ratio tier ran
        assert len(o) < len(deflate_device_dynamic(d))


def test_l6_block_size_guard():
    """The covering-decay scan packs (end << 15) into uint32; block
    sizes past the packing headroom must raise, not corrupt output."""
    from libdeflate_rsx_tpu.models.greedy_dynamic import deflate_device_l6
    with pytest.raises(ValueError):
        deflate_device_l6(b"x" * 200000, 131072)


def test_ratio_calibrate_tiny_batch_not_cached():
    """A first batch of all-tiny items must not permanently disable
    auto-mode offload for the instance."""
    from libdeflate_rsx_tpu.batch import BatchCompressor
    bc = BatchCompressor(level=6)
    assert bc._ratio_calibrate([b"x" * 10, b"y" * 20]) is False
    assert bc._ratio_ok is None          # verdict not cached
