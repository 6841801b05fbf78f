"""Batch compression/decompression — the primary entry point for offload.

Parity with the reference's batch module (reference src/batch.rs):
`BatchCompressor.compress_batch(list[bytes]) -> list[bytes]` and
`BatchDecompressor.decompress_batch(inputs, max_out_sizes) ->
list[Optional[bytes]]` with per-item fault isolation (a failed item yields
b"" / None, never aborts the batch). Where the reference offloads to a CUDA
stored-block kernel with silent CPU fallback, this build offloads to the
GPU block encoders (models/stored.py, models/greedy_static.py,
models/greedy_dynamic.py) and the GPU batch decoder
(ops/pallas/inflate_tokens.py). With `use_device=True` a device path
that fails to compile or run raises; only per-item data faults (items
over a cap, invalid items) take the host path, and `counters` counts
them. Container checksums use the host kernels (device checksums belong
to the sharded path, parallel/shard.py).
"""

from __future__ import annotations

from . import containers
from .common import MAX_LEVEL, MIN_LEVEL
from .engine import adler32 as adler32_host
from .engine import compress_raw
from .engine import crc32 as crc32_host
from .models.portable.deflate import Flush
from .utils.errors import DeflateError, LevelError

# levels served by the device encoders; higher levels use the host engine
DEVICE_LEVELS_STORED = {0}
DEVICE_LEVELS_GREEDY = {1, 2, 3}
# dynamic-Huffman device tier (per-block code tables): the ratio tier
DEVICE_LEVELS_DYNAMIC = {4, 5, 6, 7, 8, 9}

# items served per path since the last reset_counters(): device_items
# went through a device path; host_fallback_items were routed to the
# host engine by a per-item fault (decode) or by auto mode's fault
# isolation (compress)
counters = {"device_items": 0, "host_fallback_items": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def _gpu_backend() -> bool:
    import jax
    return jax.default_backend() == "gpu"


class BatchCompressor:
    """Compress many independent buffers at once.

    format: "deflate" | "zlib" | "gzip". use_device=None auto-detects
    (device path for levels it serves when JAX runs on a GPU, host
    otherwise); False forces host; True forces the device path and
    raises if it fails.
    """

    #: auto-offload ratio contract: the device tier's output may be at
    #: most this factor larger than the host engine's at the same level
    #: (otherwise auto mode silently degrades the ratio the user asked
    #: for). Explicit use_device=True skips the check (documented trade:
    #: the device tiers favor throughput; see models/greedy_dynamic.py).
    RATIO_SLACK = 1.05

    def __init__(self, level: int = 6, format: str = "deflate",
                 use_device: bool | None = None) -> None:
        if not (MIN_LEVEL <= level <= MAX_LEVEL):
            raise LevelError(f"compression level {level} outside 0..=12")
        if format not in ("deflate", "zlib", "gzip"):
            raise ValueError(f"unknown format {format!r}")
        self.level = level
        self.format = format
        self.use_device = use_device
        self._ratio_ok: bool | None = None   # auto-mode calibration cache

    # -- framing helpers ----------------------------------------------------

    def _frame(self, data: bytes, payload: bytes) -> bytes:
        if self.format == "deflate":
            return payload
        if self.format == "zlib":
            return (containers.zlib_header(self.level) + payload
                    + containers.zlib_footer(adler32_host(data)))
        return (containers.gzip_header(self.level) + payload
                + containers.gzip_footer(crc32_host(data), len(data)))

    def _device_wanted(self) -> bool:
        if self.use_device is False:
            return False
        if self.level not in (DEVICE_LEVELS_STORED | DEVICE_LEVELS_GREEDY
                              | DEVICE_LEVELS_DYNAMIC):
            return False
        if self.use_device:
            return True
        # auto mode: offload only when a GPU backs JAX — the CPU backend
        # would lose to the native host codec
        return _gpu_backend()

    def _compress_one_device(self, data: bytes) -> bytes:
        if self.level in DEVICE_LEVELS_STORED:
            from .models.stored import deflate_device_stored
            payload = deflate_device_stored(data)
        elif self.level in DEVICE_LEVELS_DYNAMIC:
            if self.level >= 6:
                # ratio tier: strided-ladder matchfinder + cross-block
                # history — the only device tier whose output size
                # passes the auto-mode ratio gate at these levels
                from .models.greedy_dynamic import deflate_device_l6
                payload = deflate_device_l6(data)
            else:
                from .models.greedy_dynamic import deflate_device_dynamic
                payload = deflate_device_dynamic(data)
        else:
            from .models.greedy_static import deflate_device_static
            payload = deflate_device_static(data)
        return self._frame(data, payload)

    def _compress_one_host(self, data: bytes) -> bytes:
        return self._frame(data, compress_raw(data, self.level, Flush.FINISH))

    def _compress_item(self, data: bytes) -> bytes:
        try:
            return self._compress_one_host(data)
        except DeflateError:
            return b""

    def _ratio_calibrate(self, items: list[bytes]) -> bool:
        """Auto-mode ratio contract: compress a small sample through both
        paths once and approve device offload only if its output stays
        within RATIO_SLACK of the host engine's at the same level.
        Cached per instance — one extra host compress of <=256 KiB on the
        first batch. Level 0 (stored) is byte-equivalent by construction.
        A device failure propagates (compress_batch counts it) and
        caches no verdict."""
        if self._ratio_ok is not None:
            return self._ratio_ok
        if self.level in DEVICE_LEVELS_STORED:
            self._ratio_ok = True
            return True
        sample = next((x for x in items if len(x) >= 4096), None)
        if sample is None:
            # tiny items: device launch overhead dominates anyway — but
            # don't cache the verdict: a later batch with a real-sized
            # item should still get to calibrate
            return False
        sample = sample[: 256 << 10]
        dev_size = len(self._compress_one_device(sample))
        host_size = len(self._compress_one_host(sample))
        self._ratio_ok = dev_size <= host_size * self.RATIO_SLACK
        return self._ratio_ok

    def _compress_device(self, items: list[bytes]) -> list[bytes]:
        if self.level in DEVICE_LEVELS_DYNAMIC and len(items) > 1:
            # dynamic tier: one batched analyze/fetch/emit for the whole
            # batch instead of a host round trip per item
            if self.level >= 6:
                from .models.greedy_dynamic import (
                    deflate_device_l6_many as _many)
            else:
                from .models.greedy_dynamic import (
                    deflate_device_dynamic_many as _many)
            return [self._frame(d, p) for d, p in zip(items, _many(items))]
        return [self._compress_one_device(d) for d in items]

    def compress_batch(self, inputs) -> list[bytes]:
        """Per-item isolation: an item that fails yields b"" (reference
        src/batch.rs:47-54) and the rest of the batch proceeds. Host
        items run on the shared thread pool (the reference's rayon
        par_iter, reference src/batch.rs:34-57)."""
        items = [bytes(x) for x in inputs]
        if self._device_wanted():
            try:
                # AUTO mode must not silently trade away the ratio the
                # user's level implies (an unguarded dynamic-tier offload
                # was a ~17% size regression at level 6) — calibrate once
                # per instance; a rejection is a choice, not a fallback
                if self.use_device or self._ratio_calibrate(items):
                    out = self._compress_device(items)
                    counters["device_items"] += len(items)
                    return out
            except Exception:
                if self.use_device:
                    raise
                # auto mode: host fallback, mirroring the CUDA->CPU
                # fallback in the reference (src/batch.rs:23-27)
                counters["host_fallback_items"] += len(items)
        from .parallel.hostpool import pmap
        return pmap(self._compress_item, items)


class BatchDecompressor:
    """Decompress many independent buffers; failed items yield None.

    use_device=True decodes raw-DEFLATE payloads with the two-pass GPU
    decoder (ops/pallas/inflate_tokens.py, all block types, up to 1 MiB
    per stream); container headers and checksums are handled host-side.
    Items the kernel cannot take (over a cap, invalid) go to the host
    decoder one by one and are counted in `counters` — the reference's
    device->CPU fallback shape (reference src/batch.rs:23-27); a device
    path that fails to compile or run raises. Default False: the host C
    decoder is faster per stream; the device path exists for offload
    (freeing host cores) and as the scaling unit for sharded meshes.
    interpret=True runs the kernel in the Pallas interpreter (CPU
    tests)."""

    def __init__(self, format: str = "deflate",
                 use_device: bool = False,
                 resolve: str = "host", interpret: bool = False) -> None:
        if format not in ("deflate", "zlib", "gzip"):
            raise ValueError(f"unknown format {format!r}")
        if resolve not in ("host", "device"):
            raise ValueError(f"resolve must be host|device: {resolve!r}")
        self.format = format
        self.use_device = use_device
        # resolve="device" keeps pass 2 (LZ copy resolution) on device
        # (ops/resolve.py) so only decoded bytes cross the host link;
        # "host" fans the C resolver out on the host pool.
        self.resolve = resolve
        self.interpret = interpret

    def _split_container(self, data: bytes):
        """-> (payload, verify_fn) for the configured format."""
        if self.format == "deflate":
            return data, lambda out: None
        if self.format == "zlib":
            start = containers.parse_zlib_header(data)

            def verify_zlib(out, data=data, start=start):
                # the footer check needs the consumed length; device
                # decode consumes the whole payload, so locate the
                # 4-byte adler at the end
                containers.verify_zlib_footer(
                    data[len(data) - 4:], adler32_host(out))

            return data[start:len(data) - 4], verify_zlib
        start = containers.parse_gzip_header(data)

        def verify_gzip(out, data=data):
            containers.verify_gzip_footer(
                data[len(data) - 8:], crc32_host(out), len(out))

        return data[start:len(data) - 8], verify_gzip

    def _decompress_batch_device(self, jobs) -> list:
        from .ops.pallas.inflate_tokens import (
            cap_bucket, inflate_device_fused, inflate_device_tokens,
            steps_for_caps)

        payloads, verifies = [], []
        for data, _ in jobs:
            try:
                payload, verify = self._split_container(data)
            except Exception:
                payload, verify = None, None   # host path decides
            payloads.append(payload)
            verifies.append(verify)
        # caps are bucketed up to 1 MiB per stream
        capped = [min(c, 1 << 20) for _, c in jobs]
        decode = (inflate_device_fused if self.resolve == "device"
                  else inflate_device_tokens)
        decoded = decode([p if p else b"" for p in payloads],
                         max_steps=steps_for_caps(capped),
                         out_cap=cap_bucket(capped),
                         interpret=self.interpret)
        out = []
        for (data, cap), verify, dec in zip(jobs, verifies, decoded):
            if dec is not None and len(dec) <= cap:
                try:
                    verify(dec)
                    out.append(dec)
                    counters["device_items"] += 1
                    continue
                except Exception:
                    pass   # e.g. trailing garbage: host path decides
            # device couldn't take it (over-cap/bad): host fallback
            counters["host_fallback_items"] += 1
            out.append(self._decompress_item((data, cap)))
        return out

    def _decompress_one(self, data: bytes, max_out: int) -> bytes:
        from .api import Decompressor
        d = Decompressor()
        if self.format == "deflate":
            return d.decompress_deflate(data, max_out)
        if self.format == "zlib":
            return d.decompress_zlib(data, max_out)
        return d.decompress_gzip(data, max_out)

    def _decompress_item(self, job) -> bytes | None:
        data, cap = job
        try:
            return self._decompress_one(data, cap)
        except Exception:
            return None

    def decompress_batch(self, inputs, max_out_sizes) -> list:
        """Thread-pool parallel with per-item fault isolation (reference
        src/batch.rs:74-101); optional device offload (see class doc)."""
        jobs = [(bytes(d), int(c)) for d, c in zip(inputs, max_out_sizes)]
        if self.use_device and jobs:
            return self._decompress_batch_device(jobs)
        from .parallel.hostpool import pmap
        return pmap(self._decompress_item, jobs)
