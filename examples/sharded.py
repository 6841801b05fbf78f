"""Multi-device data-parallel compression over a device mesh.

Run on the GPUs of one host:
  python examples/sharded.py
or simulate eight devices on the CPU (the decoder kernel then runs in
the Pallas interpreter):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/sharded.py --cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import gzip

from libdeflate_rsx_tpu.parallel import ShardedCompressor, stream_mesh

INTERPRET = "--cpu" in sys.argv
mesh = stream_mesh()
print(f"mesh: {mesh.devices.size} devices on axis '{mesh.axis_names[0]}'")

data = b"a device mesh compressing one big buffer " * 40000
sc = ShardedCompressor(mesh=mesh, block_size=65536)

# blocks shard across every device; concat offsets come from an all-gather
# exclusive scan; CRC-32 is computed per block on-device and combined
# associatively on the host
framed = sc.compress(data, format="gzip")
assert gzip.decompress(framed) == data
print(f"gzip: {len(data)} -> {len(framed)} bytes across the mesh")

# many independent buffers ride one sharded launch
outs = sc.compress_batch([data[:10000], data[:50000], data])
print("batch sizes:", [len(o) for o in outs])

# sharded device DECODE: the streams of the lockstep two-pass decoder
# are split across the same mesh
import zlib

from libdeflate_rsx_tpu.parallel import ShardedDecompressor

streams = [zlib.compress(bytes([65 + i]) * 5000 + data[:2000], 6)[2:-4]
           for i in range(6)]
dec = ShardedDecompressor(mesh, max_steps=4096, interpret=INTERPRET)
outs = dec.decompress_batch(streams)
assert all(o is not None for o in outs)
print(f"sharded decode: {len(outs)} streams OK")

# resolve="device" keeps pass 2 (LZ copy resolution) on the devices as a
# sharded XLA pointer-doubling pass — only decoded bytes leave the mesh
dec_dev = ShardedDecompressor(mesh, max_steps=4096, resolve="device",
                              out_cap=16384, interpret=INTERPRET)
outs2 = dec_dev.decompress_batch(streams)
assert outs2 == outs
print(f"sharded decode (device resolve): {len(outs2)} streams OK")

print(f"compressed {len(data)} -> {len(framed)} bytes "
      f"({len(data) / len(framed):.2f}x) across {mesh.devices.size} devices")
