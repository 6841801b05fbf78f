"""The device encoder tiers and the Pallas batch decoder.

Three device compression tiers (pick by batch level):
  level 0    -> stored blocks        (models/stored.py)
  levels 1-3 -> static Huffman       (models/greedy_static.py)
  levels 4-9 -> dynamic Huffman      (models/greedy_dynamic.py)
and the device batch decoder (ops/pallas/inflate_tokens.py via
BatchDecompressor(use_device=True)).

Runs on a CUDA GPU (the batch decoder's kernel is compiled for it):
  python examples/device_tiers.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import zlib

from libdeflate_rsx_tpu.batch import BatchCompressor, BatchDecompressor
from libdeflate_rsx_tpu.models.greedy_dynamic import deflate_device_dynamic
from libdeflate_rsx_tpu.models.greedy_static import deflate_device_static

text = (b"the dynamic tier builds one Huffman code per 64 KiB block, "
        b"so entropy-skewed data like this sentence compresses harder. "
        ) * 3000

static = deflate_device_static(text)
dynamic = deflate_device_dynamic(text)
print(f"input {len(text)} B -> static tier {len(static)} B "
      f"({len(text) / len(static):.2f}x), dynamic tier {len(dynamic)} B "
      f"({len(text) / len(dynamic):.2f}x)")
assert zlib.decompress(static, -15) == text
assert zlib.decompress(dynamic, -15) == text

# the batch API picks the tier from the level
bc = BatchCompressor(level=6, format="gzip", use_device=True)
frames = bc.compress_batch([text, text[::-1]])
print(f"batch gzip: {[len(f) for f in frames]} bytes")

# device batch decode (raw DEFLATE payloads)
chunks = [text[i:i + 65536 - 1024] for i in range(0, len(text), 65536)][:4]
comps = [zlib.compress(c, 6)[2:-4] for c in chunks]
bd = BatchDecompressor(use_device=True)
outs = bd.decompress_batch(comps, [len(c) for c in chunks])
assert outs == chunks
print(f"device batch decode: {len(outs)} streams, "
      f"{sum(len(o) for o in outs)} bytes, byte-exact")
