"""Batch compression of many independent buffers — the device-offload
entry point (reference examples/batch.rs). On a multi-GPU mesh, use
libdeflate_rsx_tpu.parallel.ShardedCompressor to spread blocks over cards."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import libdeflate_rsx_tpu as ld

inputs = [f"document number {i} ".encode() * (100 + 37 * i)
          for i in range(16)]

bc = ld.BatchCompressor(level=1, format="zlib")
compressed = bc.compress_batch(inputs)
print("compressed sizes:", [len(c) for c in compressed[:6]], "…")

bd = ld.BatchDecompressor(format="zlib")
restored = bd.decompress_batch(compressed,
                               [len(x) + 64 for x in inputs])
assert restored == inputs
print("batch round trip OK (per-item fault isolation: failures yield None)")
