"""Multi-device data parallelism: shard_map batch encode and decode.

The reference scales with rayon thread pools (reference src/batch.rs:34-57,
src/compress/mod.rs:699-772); here batches of independent blocks are
sharded across devices over a flat 1-D mesh axis "streams" (SURVEY.md §2
"Distributed communication backend"), which suits cards joined all to
all by NVLink:

 - each device encodes its rows with the gather-free static-Huffman block
   kernel (ops/encode_v2.py) entirely locally,
 - ordered concatenation offsets come from a local cumsum plus an
   `all_gather` of per-shard byte totals (the exclusive scan of
   per-block compressed sizes),
 - per-block CRC-32 / Adler-32 registers are computed on-device with the
   GF(2)-matmul kernels (ops/checksums.py) and combined associatively on
   the host (ops/checksum_math.py) — a psum-style tree, never a serial
   re-scan of the payload.

Works the same on a GPU host and on the virtual
`xla_force_host_platform_device_count` CPU mesh used by the tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.greedy_static import assemble_with_fallback, split_blocks
from ..ops.checksum_math import adler32_combine, crc32_combine
from ..ops.checksums import adler32_blocks, crc32_blocks
from ..ops.encode_dynamic import analyze_block, build_tables_host, emit_pack
from ..ops.encode_v2 import BLOCK_PAD, encode_rows_static

AXIS = "streams"


def stream_mesh(devices=None) -> Mesh:
    """1-D mesh over `devices` (default: all local devices), axis "streams"."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def _step(blocks, valids, finals, *, block_size: int, checksums: bool):
    """Per-device shard of the batch-encode step (runs under shard_map).

    blocks: (B_local, block_size + BLOCK_PAD) uint8.
    Returns (rows, byte_off, rowbits, total_bits, nbytes, offsets[, crcs,
    adlers]) — offsets are GLOBAL exclusive-scan byte positions for
    ordered concatenation, via an all-gather over the mesh axis.
    """
    enc = functools.partial(encode_rows_static, block_size=block_size)
    rows, byte_off, rowbits, total_bits, nbytes = jax.vmap(enc)(
        blocks, valids, finals)
    local_sizes = nbytes.astype(jnp.int32)
    local_scan = jnp.cumsum(local_sizes) - local_sizes
    totals = jax.lax.all_gather(jnp.sum(local_sizes), AXIS)
    me = jax.lax.axis_index(AXIS)
    prefix = jnp.sum(jnp.where(jnp.arange(totals.shape[0]) < me, totals, 0))
    offsets = local_scan + prefix
    out = (rows, byte_off, rowbits, total_bits, nbytes, offsets)
    if not checksums:
        return out
    body = blocks[:, :block_size]
    crcs = crc32_blocks(body, valids)
    adlers = adler32_blocks(body, valids)
    return out + (crcs, adlers)


@functools.lru_cache(maxsize=8)
def _jit_sharded_analyze(mesh: Mesh, block_size: int):
    """Dynamic tier, phase A: match pipeline + per-block histograms,
    data-parallel over the mesh (ops/encode_dynamic.analyze_block)."""
    fn = jax.vmap(functools.partial(analyze_block, block_size=block_size))
    mapped = jax.shard_map(
        lambda b, v: fn(b, v),
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=tuple([P(AXIS)] * 6),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=8)
def _jit_sharded_emit(mesh: Mesh, block_size: int):
    """Dynamic tier, phase B: table-coded emission + matmul packing."""
    fn = jax.vmap(functools.partial(emit_pack, block_size=block_size))
    mapped = jax.shard_map(
        lambda *a: fn(*a),
        mesh=mesh,
        in_specs=tuple([P(AXIS)] * 8),
        out_specs=tuple([P(AXIS)] * 4),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=8)
def _jit_sharded_step(mesh: Mesh, block_size: int, checksums: bool):
    fn = functools.partial(_step, block_size=block_size, checksums=checksums)
    n_out = 8 if checksums else 6
    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS)),
        out_specs=tuple([P(AXIS)] * n_out),
    )
    return jax.jit(mapped)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_blocks(data: bytes, block_size: int, n_devices: int):
    """Split one buffer into device-shardable padded block rows; the row
    count is padded to a multiple of n_devices (padding rows are empty
    final blocks whose outputs are dropped at assembly)."""
    arr, valid, finals, num = split_blocks(data, block_size)
    rows = _round_up(num, n_devices)
    if rows > num:
        pad = rows - num
        arr = np.concatenate(
            [arr, np.zeros((pad, arr.shape[1]), np.uint8)])
        valid = np.concatenate([valid, np.zeros(pad, np.int32)])
        finals = np.concatenate([finals, np.ones(pad, bool)])
    return arr, valid, finals, num


class ShardedCompressor:
    """Data-parallel whole-buffer / batch DEFLATE encoder over a mesh.

    The flagship multi-device path: level-1-tier static-Huffman blocks,
    sharded over the "streams" mesh axis, with device checksums and
    associative host combination for zlib/gzip framing.
    """

    def __init__(self, mesh: Mesh | None = None,
                 block_size: int = 65536, tier: str = "static") -> None:
        if tier not in ("static", "dynamic"):
            raise ValueError(f"unknown tier {tier!r}")
        self.mesh = mesh if mesh is not None else stream_mesh()
        self.block_size = block_size
        self.tier = tier
        self.n_devices = self.mesh.devices.size

    def _run(self, blocks, valids, finals, checksums: bool):
        step = _jit_sharded_step(self.mesh, self.block_size, checksums)
        sharding = NamedSharding(self.mesh, P(AXIS))
        args = [jax.device_put(jnp.asarray(a), sharding)
                for a in (blocks, valids, finals)]
        return step(*args)

    def _run_dynamic(self, blocks, valids, finals):
        """Dynamic tier: sharded analyze -> host code tables (only the
        few-KB histograms cross the link) -> sharded emit. Returns
        per-block parts (list[bytes])."""
        from ..models.greedy_dynamic import assemble_dynamic

        num = len(blocks)
        sharding = NamedSharding(self.mesh, P(AXIS))
        b_j = jax.device_put(jnp.asarray(blocks), sharding)
        v_j = jax.device_put(jnp.asarray(valids), sharding)
        ml, dist, sel, lit, llh, ofh = _jit_sharded_analyze(
            self.mesh, self.block_size)(b_j, v_j)
        ll_tabs, of_tabs, headers, hdr_bits = build_tables_host(
            llh, ofh, finals)
        device_out = _jit_sharded_emit(self.mesh, self.block_size)(
            b_j, ml, dist, sel, lit,
            jax.device_put(jnp.asarray(ll_tabs), sharding),
            jax.device_put(jnp.asarray(of_tabs), sharding),
            jax.device_put(jnp.asarray(hdr_bits.astype(np.int32)),
                           sharding))
        out_cap = 2 * self.block_size + 1024
        return assemble_dynamic(device_out, headers, hdr_bits, ll_tabs,
                                finals, num, out_cap)

    def _assemble(self, data: bytes, out, valids, finals, num) -> bytes:
        parts = assemble_with_fallback(
            data, self.block_size, out[:5], valids, finals, num)
        return b"".join(parts)

    def compress(self, data: bytes, format: str = "deflate",
                 final: bool = True) -> bytes:
        """Compress one buffer, blocks sharded across every device.

        final=False emits the last real block as a non-final SYNC-joined
        block (byte-aligned), so streams from successive shards
        concatenate into one valid DEFLATE stream - the multi-host
        ordered-gather building block (only raw deflate supports it).
        """
        if not final and format != "deflate":
            raise ValueError("final=False requires format='deflate'")
        blocks, valids, finals, num = shard_blocks(
            data, self.block_size, self.n_devices)
        if not final:
            finals[:num] = False
        if self.tier == "dynamic":
            from ..models.greedy_dynamic import apply_stored_fallback
            parts = self._run_dynamic(blocks, valids, finals)[:num]
            payload = b"".join(apply_stored_fallback(
                parts, data, self.block_size, valids, finals, num))
            if format == "deflate":
                return payload
            from .. import containers
            from ..engine import adler32 as adler32_h
            from ..engine import crc32 as crc32_h
            if format == "zlib":
                return (containers.zlib_header(6) + payload
                        + containers.zlib_footer(adler32_h(data)))
            return (containers.gzip_header(6) + payload
                    + containers.gzip_footer(crc32_h(data), len(data)))
        want_sums = format in ("zlib", "gzip")
        out = self._run(blocks, valids, finals, want_sums)
        payload = self._assemble(data, out, valids, finals, num)
        if format == "deflate":
            return payload
        from .. import containers
        lens = np.asarray(valids)
        if format == "zlib":
            adlers = np.asarray(out[7])
            adler = 1
            for b in range(num):
                adler = adler32_combine(adler, int(adlers[b]), int(lens[b]))
            return (containers.zlib_header(1) + payload
                    + containers.zlib_footer(adler))
        crcs = np.asarray(out[6])
        crc = 0
        for b in range(num):
            crc = crc32_combine(crc, int(crcs[b]), int(lens[b]))
        return (containers.gzip_header(1) + payload
                + containers.gzip_footer(crc, len(data)))

    def compress_batch(self, inputs) -> list[bytes]:
        """Many independent buffers: all their blocks ride one sharded
        launch; outputs are re-assembled per input in order."""
        metas = []
        all_blocks, all_valids, all_finals = [], [], []
        row = 0
        for item in inputs:
            data = bytes(item)
            blocks, valids, finals, num = split_blocks(data, self.block_size)
            metas.append((row, num, data))
            row += num
            all_blocks.append(blocks)
            all_valids.append(valids)
            all_finals.append(finals)
        if not metas:
            return []
        blocks = np.concatenate(all_blocks)
        valids = np.concatenate(all_valids)
        finals = np.concatenate(all_finals)
        rows = _round_up(len(blocks), self.n_devices)
        pad = rows - len(blocks)
        if pad:
            blocks = np.concatenate(
                [blocks, np.zeros((pad, blocks.shape[1]), np.uint8)])
            valids = np.concatenate([valids, np.zeros(pad, np.int32)])
            finals = np.concatenate([finals, np.ones(pad, bool)])
        if self.tier == "dynamic":
            from ..models.greedy_dynamic import apply_stored_fallback
            parts = self._run_dynamic(blocks, valids, finals)
            results = []
            for start, num, data in metas:
                sub = apply_stored_fallback(
                    parts[start:start + num], data, self.block_size,
                    valids[start:start + num],
                    finals[start:start + num], num)
                results.append(b"".join(sub))
            return results
        out = self._run(blocks, valids, finals, False)
        results = []
        for start, num, data in metas:
            sub = tuple(np.asarray(a)[start:start + num] for a in out[:5])
            parts = assemble_with_fallback(
                data, self.block_size, sub,
                valids[start:start + num], finals[start:start + num], num)
            results.append(b"".join(parts))
        return results


@functools.lru_cache(maxsize=16)
def _sharded_pass1(mesh, programs: int, lanes: int, max_steps: int,
                   in_cap: int, out_cap: int, interpret: bool):
    """jit(shard_map(pass 1)) cached by configuration: each device runs
    the pass-1 kernel over its own `programs` programs of streams."""
    from ..ops.pallas import inflate_tokens as it

    run = it._jit_pass1(programs, lanes, max_steps, in_cap, out_cap,
                        interpret)
    return jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(None, AXIS), P(None, AXIS)), check_vma=False))


@functools.lru_cache(maxsize=16)
def _sharded_resolve(mesh, out_cap: int):
    """jit(shard_map(resolver)) cached by configuration; each device
    resolves the token columns it decoded."""
    from ..ops.resolve import resolve_batch_jax

    return jax.jit(jax.shard_map(
        lambda tok: resolve_batch_jax(tok.T, out_cap), mesh=mesh,
        in_specs=P(None, AXIS), out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False))


class ShardedDecompressor:
    """Data-parallel batch DEFLATE decode over a mesh.

    The streams of the two-pass decoder (ops/pallas/inflate_tokens.py)
    are sharded across the "streams" mesh axis with shard_map: each
    device entropy-decodes its streams in lockstep, and LZ resolution
    runs either through the native C resolver on the host pool
    (resolve="host") or as the sharded XLA copy-resolution pass on the
    same devices (resolve="device", ops/resolve.py) so only decoded
    bytes leave the mesh. The multi-device analog of the reference's
    per-thread batch decompression (reference src/batch.rs:74-101).
    interpret=True runs the kernel in the Pallas interpreter (CPU
    tests).
    """

    def __init__(self, mesh: Mesh | None = None,
                 max_steps: int = 72 * 1024,
                 resolve: str = "host", out_cap: int = 65536,
                 interpret: bool = False) -> None:
        self.mesh = mesh if mesh is not None else stream_mesh()
        self.n_devices = self.mesh.devices.size
        self.max_steps = max_steps
        if resolve not in ("host", "device"):
            raise ValueError(f"resolve must be host|device: {resolve!r}")
        self.resolve = resolve
        self.out_cap = out_cap
        self.interpret = interpret

    def decompress_batch(self, streams: list[bytes]) -> list:
        from ..ops.pallas import inflate_tokens as it

        n = len(streams)
        if n == 0:
            return []
        programs, lanes = it.layout(n, self.n_devices)
        in_cap = it.in_cap_bucket(streams)
        inbits, words, ok = it.pack_streams(streams, programs * lanes,
                                            in_cap)
        sharding = NamedSharding(self.mesh, P(AXIS))
        fn = _sharded_pass1(self.mesh, programs // self.n_devices, lanes,
                            self.max_steps, in_cap, self.out_cap,
                            self.interpret)
        tok, stats = fn(jax.device_put(inbits, sharding),
                        jax.device_put(words, sharding))
        stats = np.asarray(stats)
        if self.resolve == "device":
            out, outlen, okr = _sharded_resolve(self.mesh, self.out_cap)(tok)
            return it.fused_results(out, outlen, okr, stats, ok, n,
                                    self.out_cap)
        from .hostpool import pmap
        # pass 2: parallel LZ copy-resolution on the host pool
        return pmap(it._resolve_one,
                    it.token_columns(tok, stats, ok, n, self.max_steps))
