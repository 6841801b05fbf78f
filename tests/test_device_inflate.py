"""Device batch decoder behaviour (ops/pallas/inflate_tokens.py).

Runs the pass-1 kernel in the Pallas interpreter on the CPU test
backend, through the same compiled variant as test_inflate_tokens.py.
Differential oracle: CPython zlib produces the streams (the reference's
libdeflater oracle pattern, SURVEY.md §4).
"""

import random
import zlib

import pytest

from tests.conftest import make_corpus
from tests.test_inflate_tokens import _run as _inflate


def test_dynamic_static_stored_blocks():
    bash_like = make_corpus("pattern", 12000, seed=3)
    cases = [
        zlib.compress(b"ab" * 2000, 9)[2:-4],            # tiny alphabet
        zlib.compress(make_corpus("text", 20000), 6)[2:-4],   # dynamic
        zlib.compress(b"hi", 6)[2:-4],                   # static
        zlib.compress(bash_like, 0)[2:-4],               # stored
        zlib.compress(make_corpus("random", 2000), 6)[2:-4],  # incompressible
        zlib.compress(b"\0" * 40000, 6)[2:-4],           # RLE-heavy
    ]
    expect = [b"ab" * 2000, make_corpus("text", 20000), b"hi",
              bash_like, make_corpus("random", 2000), b"\0" * 40000]
    assert _inflate(cases) == expect


@pytest.mark.parametrize("off", [1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 300])
def test_per_offset_copy_paths(off):
    r = random.Random(off)
    base = bytes(r.randrange(256) for _ in range(off))
    data = (base * (20000 // off + 2))[:20000]
    comp = zlib.compress(data, 6)[2:-4]
    assert _inflate([comp]) == [data]


def test_all_levels_roundtrip():
    data = make_corpus("text", 15000, seed=9)
    cases = [zlib.compress(data, lvl)[2:-4] for lvl in range(0, 10)]
    assert _inflate(cases) == [data] * 10


def test_garbage_yields_none_not_crash():
    r = random.Random(77)
    blobs = [bytes(r.randrange(256) for _ in range(r.randrange(1, 200)))
             for _ in range(6)]
    good = zlib.compress(b"sane data " * 50, 6)[2:-4]
    res = _inflate(blobs + [good])
    assert res[-1] == b"sane data " * 50
    # garbage: None or (rarely) a valid-by-chance decode; never raises


def test_truncated_yields_none():
    data = make_corpus("text", 20000, seed=1)
    comp = zlib.compress(data, 6)[2:-4]
    res = _inflate([comp[: len(comp) // 2], comp])
    assert res[0] is None
    assert res[1] == data


def test_over_cap_yields_none():
    big = zlib.compress(make_corpus("random", 80000, seed=2), 6)[2:-4]
    assert len(big) > 65536
    assert _inflate([big], in_cap=65536) == [None]


def test_batch_decompressor_device_path():
    from libdeflate_rsx_tpu import batch
    from libdeflate_rsx_tpu.batch import BatchCompressor, BatchDecompressor

    items = [make_corpus("text", 12000, seed=5),
             make_corpus("pattern", 9000, seed=6),
             b"",
             make_corpus("random", 90000, seed=7)]   # over a 64 KiB cap
    for fmt in ("deflate", "zlib", "gzip"):
        comp = BatchCompressor(level=6, format=fmt,
                               use_device=False).compress_batch(items)
        dec = BatchDecompressor(format=fmt, use_device=True,
                                interpret=True)
        batch.reset_counters()
        out = dec.decompress_batch(comp, [max(len(x), 1) for x in items])
        assert out == items, fmt
        # only the empty raw stream is a host item (no DEFLATE data)
        assert batch.counters["device_items"] >= 3, fmt


def test_batch_decompressor_device_fault_isolation():
    from libdeflate_rsx_tpu import batch
    from libdeflate_rsx_tpu.batch import BatchDecompressor

    good = zlib.compress(b"x" * 5000, 6)[2:-4]
    dec = BatchDecompressor(use_device=True, interpret=True)
    batch.reset_counters()
    out = dec.decompress_batch([good, b"\x07\x00", good], [5000, 100, 5000])
    assert out[0] == b"x" * 5000
    assert out[1] is None
    assert out[2] == b"x" * 5000
    assert batch.counters == {"device_items": 2, "host_fallback_items": 1}
