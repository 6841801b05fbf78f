"""Native host-runtime kernels (C, built on first use).

The reference's host path is entirely native (Rust); this package holds
the native host engine: the CPython extension `_codec` (pymod.c +
codec.c, the fast call path) and the ctypes library `_native` (codec.c
+ assemble.c, the GIL-free entry points and the row assembler). Both are
compiled from the committed sources on first use; a failed compile
raises `NativeBuildError` with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "_native.so")
_SRCS = [os.path.join(_HERE, "assemble.c"),
         os.path.join(_HERE, "codec.c")]

_lib = None

_EXT_SO = os.path.join(_HERE, "_codec.so")
_EXT_SRCS = [os.path.join(_HERE, "pymod.c"),
             os.path.join(_HERE, "codec.c")]
_ext = None


class NativeBuildError(RuntimeError):
    """The C compiler failed on the native engine's sources."""


def _compile(so: str, srcs: list[str], extra: list[str]) -> str:
    """Build `so` from `srcs` unless it is newer than every source.

    The object is compiled under a temporary name in the same directory
    and moved into place with os.replace, so processes that build at
    the same time never load a half-written file. -march=native mirrors
    the reference's -C target-cpu=native (reference
    .cargo/config.toml:1-2); it is dropped for compilers without it.
    """
    newest_src = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(so) and os.path.getmtime(so) >= newest_src:
        return so
    cc = os.environ.get("CC", "cc")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        errors = []
        for march in (["-march=native"], []):
            cmd = [cc, "-O3", *march, "-shared", "-fPIC", *extra,
                   "-o", tmp, *srcs]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise NativeBuildError(f"cannot run {cc!r}: {e}") from e
            if r.returncode == 0:
                os.replace(tmp, so)
                return so
            errors.append(f"$ {' '.join(cmd)}\n{r.stderr}")
        raise NativeBuildError("native engine build failed:\n"
                               + "\n".join(errors))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_ext():
    """The CPython extension module (fast call path)."""
    global _ext
    if _ext is None:
        import importlib.machinery
        import importlib.util
        so = _compile(_EXT_SO, _EXT_SRCS,
                      [f"-I{sysconfig.get_paths()['include']}"])
        loader = importlib.machinery.ExtensionFileLoader("_codec", so)
        spec = importlib.util.spec_from_loader("_codec", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _ext = mod
    return _ext


def get_lib():
    """The loaded ctypes library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_compile(_SO, _SRCS, []))
        # eager init while single-threaded (GIL held here; the hot
        # entry points are later called GIL-released from pool threads)
        lib.ldrsx_global_init.restype = None
        lib.ldrsx_global_init()
        lib.assemble_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.assemble_rows.restype = None
        lib.deflate_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.deflate_c.restype = ctypes.c_int64
        lib.inflate_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.inflate_c.restype = ctypes.c_int64
        lib.crc32_c.argtypes = [
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64]
        lib.crc32_c.restype = ctypes.c_uint32
        lib.adler32_c.argtypes = [
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64]
        lib.adler32_c.restype = ctypes.c_uint32
        lib.dyn_tables_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.dyn_tables_c.restype = ctypes.c_int64
        lib.icx_size.argtypes = []
        lib.icx_size.restype = ctypes.c_int64
        lib.icx_init.argtypes = [ctypes.c_void_p]
        lib.icx_init.restype = None
        lib.icx_step.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.icx_step.restype = ctypes.c_int64
        _lib = lib
    return _lib


_HDR_CAP = 512


def dyn_tables_native(ll_hist, of_hist, final: bool):
    """Histograms -> (ll_tab (288,) u32 `code|len<<16`, of_tab (30,) u32,
    header bytes, header bits) via the C builder. Raises on Huffman
    build failure (histograms from the device pipeline are always
    buildable)."""
    import numpy as np

    lib = get_lib()
    llf = np.ascontiguousarray(ll_hist, dtype=np.uint32)
    off = np.ascontiguousarray(of_hist[:30], dtype=np.uint32)
    ll_tab = np.zeros(288, np.uint32)
    of_tab = np.zeros(30, np.uint32)
    hdr = np.zeros(_HDR_CAP, np.uint8)
    bits = lib.dyn_tables_c(
        llf.ctypes.data, off.ctypes.data, 1 if final else 0,
        ll_tab.ctypes.data, of_tab.ctypes.data, hdr.ctypes.data, _HDR_CAP)
    if bits < 0:
        raise RuntimeError(f"dyn_tables_c failed: {bits}")
    return ll_tab, of_tab, hdr[: (bits + 7) // 8].tobytes(), int(bits)


def assemble_rows_native(out, rows, byte_off, extent) -> bool:
    """OR-place row buffers into per-block output arrays.

    out: (B, out_cap) uint8 C-contiguous (modified in place);
    rows: (B, R, W) uint8; byte_off/extent: (B, R) int64.
    Returns False, and writes nothing, when `out` is not C-contiguous
    uint8.
    """
    import numpy as np

    lib = get_lib()
    if not (out.flags["C_CONTIGUOUS"] and out.dtype == np.uint8):
        return False  # a copy would break the in-place contract
    rows_c = np.ascontiguousarray(rows, dtype=np.uint8)
    off_c = np.ascontiguousarray(byte_off, dtype=np.int64)
    ext_c = np.ascontiguousarray(extent, dtype=np.int64)
    b, r, w = rows_c.shape
    lib.assemble_rows(
        out.ctypes.data, rows_c.ctypes.data, off_c.ctypes.data,
        ext_c.ctypes.data, b, r, w, out.shape[1])
    return True
