"""Checks of the compiled device kernels against the plain references.

Shared by the `gpu`-marked tests (tests/test_gpu.py) and chip_smoke.py,
which runs them on a GPU: the pytest run itself is held to the CPU.
Every check asserts exact equality; there is no tolerance.
"""

from __future__ import annotations

import zlib


def raw_deflate(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def check_decode(raws: list[bytes], level: int = 6) -> dict:
    """Decode CPython zlib's raw-DEFLATE streams of `raws` with the
    compiled pass-1 kernel. Every token column must resolve to its
    input through the numpy reference resolver, the C resolver and the
    device resolver (ops/resolve.py). Returns the step counts."""
    from libdeflate_rsx_tpu.native.host import native_resolve_tokens
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as it
    from libdeflate_rsx_tpu.ops.tokens import resolve_tokens_np

    caps = [len(d) for d in raws]
    max_steps = it.steps_for_caps(caps)
    out_cap = it.cap_bucket(caps)
    tok, stats, ok = it._pass1([raw_deflate(d, level) for d in raws],
                               max_steps, None, out_cap, False)
    cols = it.token_columns(tok, stats, ok, len(raws), max_steps)
    fused = it.fused_results(
        *it.resolve_tokens_device(tok, len(raws), out_cap), stats, ok,
        len(raws), out_cap)
    for i, ((col, n), d, dev) in enumerate(zip(cols, raws, fused)):
        assert col is not None, (
            f"stream {i}: mode {stats[it.S_MODE, i]} after "
            f"{stats[it.S_LASTSTEP, i]} of {max_steps} steps")
        assert n == len(d), f"stream {i}: length {n} != {len(d)}"
        assert native_resolve_tokens(col, n) == d, f"stream {i}: C"
        assert resolve_tokens_np(col, n) == d, f"stream {i}: numpy"
        assert dev == d, f"stream {i}: device resolver"
    return {"streams": len(raws), "max_steps": max_steps,
            "laststep": int(stats[it.S_LASTSTEP].max())}


def check_checksums(data: bytes) -> None:
    """Device CRC-32 and Adler-32 against CPython zlib."""
    from libdeflate_rsx_tpu.ops.checksums import adler32_device, crc32_device

    assert crc32_device(data) == zlib.crc32(data), "crc32"
    assert adler32_device(data) == zlib.adler32(data), "adler32"
