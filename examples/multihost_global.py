"""Multi-host global container: every host emits the byte-identical
gzip file for one logical buffer sharded across hosts.

Single-process demo (the 2-process version is exercised by
tests/test_multihost.py with real jax.distributed workers):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/multihost_global.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import gzip

from libdeflate_rsx_tpu.parallel import multihost as mh

data = b"one logical file, block-sharded across hosts and devices " * 30000
out = mh.compress_global(data, "gzip", block_size=65536)
assert gzip.decompress(out) == data
print(f"global gzip container: {len(data)} -> {len(out)} bytes; "
      f"per-host slices are SYNC-joined non-final shards, checksums "
      f"combine associatively across hosts")
