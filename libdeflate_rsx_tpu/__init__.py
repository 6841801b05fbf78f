"""libdeflate_rsx_tpu — a DEFLATE / zlib / gzip codec framework in JAX.

Brand-new JAX/XLA/Pallas implementation with the capabilities of the
reference Rust library 404Setup/libdeflate-rsx (see SURVEY.md): one-shot and
streaming compression at levels 0..=12, table-driven resumable
decompression, zlib/gzip framing with CRC-32/Adler-32, batch APIs with
per-item fault isolation, zip-bomb and overlap guards — with the compute
path re-designed for accelerators: matmul checksums, block-parallel
encoders, a Pallas GPU batch decoder, and `shard_map` data parallelism
over device meshes.

Public surface (parity with reference src/lib.rs re-exports):
  Compressor, Decompressor, crc32, adler32, plus batch/stream/parallel
  submodules.
"""

from .api import (
    Compressor,
    Decompressor,
    deflate_compress_bound,
    gzip_compress_bound,
    zlib_compress_bound,
)
from .batch import BatchCompressor, BatchDecompressor
from .engine import Deflater
from .engine import adler32 as adler32_host
from .engine import crc32 as crc32_host
from .stream import (DeflateDecoder, DeflateEncoder, GzipDecoder,
                     GzipEncoder)
from .utils import errors

__version__ = "0.1.0"


# one-time direct binding of the C-extension checksum entry points: the
# layered dispatch (engine -> host wrapper -> get_ext) costs ~900 ns per
# call, which dominates small-buffer checksums (the reference's analog
# is its OnceLock-cached function pointers, reference src/crc32/mod.rs:
# 332-365)
def _bind_checksums():
    from .native import get_ext
    ext = get_ext()
    return ext.crc32, ext.adler32


_ext_crc32, _ext_adler32 = _bind_checksums()


def crc32(data, crc: int = 0) -> int:
    """CRC-32 (gzip polynomial) of `data`, continuing from `crc`."""
    if _ext_crc32 is not None and type(data) is bytes:
        return _ext_crc32(data, crc)
    return crc32_host(bytes(data), crc)


def adler32(data, adler: int = 1) -> int:
    """Adler-32 (zlib) of `data`, continuing from `adler`."""
    if _ext_adler32 is not None and type(data) is bytes:
        return _ext_adler32(data, adler)
    return adler32_host(bytes(data), adler)


__all__ = [
    "Compressor",
    "Decompressor",
    "BatchCompressor",
    "BatchDecompressor",
    "Deflater",
    "DeflateEncoder",
    "DeflateDecoder",
    "GzipEncoder",
    "GzipDecoder",
    "crc32",
    "adler32",
    "deflate_compress_bound",
    "zlib_compress_bound",
    "gzip_compress_bound",
    "errors",
    "__version__",
]
