"""Multi-host batch dispatch.

The reference is single-process (rayon); SURVEY.md §2 specifies the
multi-host scaling path: shard batches of independent streams across
hosts with `jax.distributed`, keep block encoding local to each host's
devices, and reduce only tiny metadata (sizes, checksum
registers) globally. That shape is exactly what this module implements:

 - `initialize()` — standard multi-process bring-up (jax.distributed).
 - `process_local_batch()` — deterministic round-robin split of a global
   batch; every host computes the same split, no coordination traffic.
 - `compress_local_shard()` — this host's shard through the sharded
   device encoder on LOCAL devices only (compressed streams are
   independent; nothing host-crossing in the hot path).
 - `global_sizes()` — the one cross-host collective: an all-gather (psum
   formulation) of per-host compressed byte totals, giving every host
   the global concatenation offsets without moving payload bytes.

Single-host meshes work without any of this; call `initialize()` once per
process on a multi-host slice before using the global helpers. Tested by
tests/test_multihost.py with two real jax.distributed processes on the
CPU backend (the test analog of two hosts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .shard import AXIS, ShardedCompressor, stream_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize with env-var fallback (the standard
    multi-process bring-up; a no-op when already initialized)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError:
        pass  # already initialized


def global_stream_mesh() -> Mesh:
    """1-D "streams" mesh over every device of every host. With a
    NamedSharding over this mesh, per-host blocks stay on local devices
    (data parallel across hosts) and collectives cross hosts only for
    the per-shard metadata."""
    return Mesh(np.asarray(jax.devices()), (AXIS,))


def process_local_batch(inputs: list) -> list:
    """The shard of a global batch this process should compress: balanced
    round-robin by process index. Deterministic — every host computes
    the same split with zero coordination."""
    pid = jax.process_index()
    n = jax.process_count()
    return [b for i, b in enumerate(inputs) if i % n == pid]


def compress_local_shard(inputs: list, block_size: int = 65536,
                         level_tier: str = "static") -> list[bytes]:
    """Compress this host's round-robin shard of a global batch on this
    host's local devices. Payload bytes never cross hosts: each stream is
    independent, so inter-host traffic is only the metadata exchange in
    `global_sizes` (callers move the compressed bytes with their own
    storage/RPC layer, as in any production batch system)."""
    local = process_local_batch(inputs)
    if not local:
        return []
    sc = ShardedCompressor(stream_mesh(jax.local_devices()),
                           block_size=block_size)
    return sc.compress_batch(local)


def global_sizes(local_total: int) -> np.ndarray:
    """All-gather per-host compressed byte totals across hosts: the exclusive
    scan of the result is every host's write offset for ordered global
    concatenation (SURVEY.md §2: 'all-gather per-block compressed sizes +
    an exclusive-scan of offsets'). Runs a real collective on the global
    mesh — the only inter-host communication in the pipeline."""
    mesh = global_stream_mesh()
    nproc = jax.process_count()
    per_dev = len(jax.local_devices())

    def gather(x):
        return jax.lax.all_gather(jnp.sum(x), AXIS)

    # all_gather replicates the result; VMA inference can't prove that
    # statically, hence check_vma=False with replicated out_specs
    fn = jax.jit(jax.shard_map(gather, mesh=mesh, in_specs=P(AXIS),
                               out_specs=P(None), check_vma=False))
    # each local device contributes total/per_dev; the residue rides
    # device 0 so the global sum is exact
    base = local_total // per_dev
    vals = np.full(per_dev, base, np.int64)
    vals[0] += local_total - base * per_dev
    from jax import make_array_from_process_local_data
    from jax.sharding import NamedSharding
    garr = make_array_from_process_local_data(
        NamedSharding(mesh, P(AXIS)), vals)
    out = np.asarray(fn(garr))          # (n_devices,) per-device totals
    return out.reshape(nproc, per_dev).sum(axis=1)


def _host_slices(total_len: int, block_size: int) -> list[tuple[int, int]]:
    """Contiguous per-host byte ranges, aligned to block_size so blocks
    never straddle hosts. Deterministic on every host."""
    n = jax.process_count()
    nblocks = max(1, -(-total_len // block_size))
    per = -(-nblocks // n)
    out = []
    for p in range(n):
        lo = min(p * per * block_size, total_len)
        hi = min((p + 1) * per * block_size, total_len)
        out.append((lo, hi))
    return out


def compress_global(data: bytes, format: str = "gzip",
                    block_size: int = 65536) -> bytes:
    """One byte-exact global container across hosts (VERDICT round-2
    item 5; SURVEY.md section 2 'Distributed communication backend').

    Each host compresses its contiguous block-aligned slice of `data`
    on its local chips (non-final SYNC-joined blocks except the global
    tail), then the per-host compressed payloads, sizes, and checksum
    registers are all-gathered across hosts; every host assembles the
    identical gzip/zlib/deflate stream and combines the checksum
    registers with the associative crc32/adler32 algebra
    (ops/checksum_math.py) instead of re-hashing payload bytes.
    """
    from jax.experimental import multihost_utils

    from .. import containers
    from ..engine import adler32 as adler32_h
    from ..engine import crc32 as crc32_h
    from ..ops.checksum_math import adler32_combine, crc32_combine

    pid = jax.process_index()
    nproc = jax.process_count()
    slices = _host_slices(len(data), block_size)
    lo, hi = slices[pid]
    my = data[lo:hi]
    is_last = pid == nproc - 1 or slices[pid + 1][0] >= len(data)

    sc = ShardedCompressor(stream_mesh(jax.local_devices()),
                           block_size=block_size)
    if my:
        payload = sc.compress(my, "deflate", final=is_last)
    else:
        # empty shard on this host; the global tail owner emits the
        # final empty block if the whole input is empty
        payload = b""
    if pid == 0 and not data:
        payload = sc.compress(b"", "deflate", final=True)

    crc = crc32_h(my) if format == "gzip" else 0
    adl = adler32_h(my) if format == "zlib" else 1

    # ---- cross-host all-gathers: payload bytes + (size, crc, adler, len)
    meta = np.array([len(payload), crc, adl, len(my)], np.int64)
    metas = np.asarray(multihost_utils.process_allgather(meta))
    if metas.ndim == 1:
        metas = metas[None]
    pad = int(metas[:, 0].max())
    buf = np.zeros(pad if pad else 1, np.uint8)
    if payload:
        buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    bufs = np.asarray(multihost_utils.process_allgather(buf))
    if bufs.ndim == 1:
        bufs = bufs[None]

    body = b"".join(bufs[p, :int(metas[p, 0])].tobytes()
                    for p in range(nproc))
    if format == "deflate":
        return body
    if format == "zlib":
        adler = 1
        for p in range(nproc):
            adler = adler32_combine(adler, int(metas[p, 2]),
                                    int(metas[p, 3]))
        return (containers.zlib_header(1) + body
                + containers.zlib_footer(adler))
    gcrc = 0
    for p in range(nproc):
        gcrc = crc32_combine(gcrc, int(metas[p, 1]), int(metas[p, 3]))
    return (containers.gzip_header(1) + body
            + containers.gzip_footer(gcrc, len(data)))
