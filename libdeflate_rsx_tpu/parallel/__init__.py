"""Multi-chip parallelism layer: device meshes, shard_map batch encode,
ordered-concatenation offset scans, and associative checksum reduction.

Device-mesh replacement for the reference's rayon thread-pool parallelism
(reference src/batch.rs, src/compress/mod.rs:699-772) and its CUDA batch
offload stub (reference src/batch_cuda.rs).
"""

from .shard import (AXIS, ShardedCompressor, ShardedDecompressor,
                    shard_blocks, stream_mesh)

__all__ = ["AXIS", "ShardedCompressor", "ShardedDecompressor",
           "shard_blocks", "stream_mesh"]
