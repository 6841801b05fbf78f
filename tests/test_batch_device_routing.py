"""Device routing of the batch API (batch.py): forced device paths raise
on device failure, auto mode falls back to the host and counts it, and
per-item data faults are counted as host fallbacks."""

import zlib

import pytest

from tests.conftest import make_corpus


def _boom(*_a, **_k):
    raise RuntimeError("device path failed")


def test_forced_device_compress_raises(monkeypatch):
    from libdeflate_rsx_tpu.batch import BatchCompressor

    bc = BatchCompressor(level=1, use_device=True)
    monkeypatch.setattr(bc, "_compress_device", _boom)
    with pytest.raises(RuntimeError, match="device path failed"):
        bc.compress_batch([b"abc" * 100])


def test_auto_mode_falls_back_and_counts(monkeypatch):
    from libdeflate_rsx_tpu import batch

    monkeypatch.setattr(batch, "_gpu_backend", lambda: True)
    bc = batch.BatchCompressor(level=0)          # stored: no calibration
    monkeypatch.setattr(bc, "_compress_device", _boom)
    items = [make_corpus("text", 5000, seed=i) for i in range(3)]
    batch.reset_counters()
    outs = bc.compress_batch(items)
    assert [zlib.decompress(o, -15) for o in outs] == items
    assert batch.counters == {"device_items": 0, "host_fallback_items": 3}


def test_auto_mode_counts_failed_calibration(monkeypatch):
    """A device failure during the level-6 ratio calibration is counted
    as a fallback, batch after batch, and never cached as a verdict."""
    from libdeflate_rsx_tpu import batch

    monkeypatch.setattr(batch, "_gpu_backend", lambda: True)
    bc = batch.BatchCompressor(level=6)
    monkeypatch.setattr(bc, "_compress_one_device", _boom)
    items = [make_corpus("text", 5000, seed=i) for i in range(2)]
    batch.reset_counters()
    for _ in range(2):
        outs = bc.compress_batch(items)
        assert [zlib.decompress(o, -15) for o in outs] == items
    assert bc._ratio_ok is None
    assert batch.counters == {"device_items": 0, "host_fallback_items": 4}


def test_auto_mode_stays_on_host_without_gpu():
    from libdeflate_rsx_tpu import batch

    assert not batch._gpu_backend()              # the CPU test backend
    bc = batch.BatchCompressor(level=1)
    assert not bc._device_wanted()
    batch.reset_counters()
    out = bc.compress_batch([b"hello " * 50])
    assert zlib.decompress(out[0], -15) == b"hello " * 50
    assert batch.counters == {"device_items": 0, "host_fallback_items": 0}


def test_forced_device_compress_counts_items():
    from libdeflate_rsx_tpu import batch

    items = [make_corpus("pattern", 3000, seed=i) for i in range(2)]
    batch.reset_counters()
    outs = batch.BatchCompressor(level=1, format="zlib",
                                 use_device=True).compress_batch(items)
    assert [zlib.decompress(o) for o in outs] == items
    assert batch.counters == {"device_items": 2, "host_fallback_items": 0}


def test_forced_device_decode_raises_off_gpu():
    """Without interpret=True the compiled kernel is required: on the
    CPU the device decode raises instead of quietly using the host."""
    from libdeflate_rsx_tpu.batch import BatchDecompressor

    comp = zlib.compress(b"x" * 1000)[2:-4]
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        BatchDecompressor(use_device=True).decompress_batch([comp], [1000])


def test_decode_data_faults_counted_per_item():
    from libdeflate_rsx_tpu import batch

    good = zlib.compress(b"y" * 3000)
    bad_crc = good[:-4] + b"\0\0\0\0"            # zlib footer mismatch
    dec = batch.BatchDecompressor(format="zlib", use_device=True,
                                  interpret=True)
    batch.reset_counters()
    out = dec.decompress_batch([good, bad_crc, b"\x78"], [3000] * 3)
    assert out == [b"y" * 3000, None, None]
    assert batch.counters == {"device_items": 1, "host_fallback_items": 2}
