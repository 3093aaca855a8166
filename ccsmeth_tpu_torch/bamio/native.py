"""ctypes bindings for the native multithreaded BGZF codec (native/bgzf_mt.cpp).

Auto-builds the shared library on first use when a compiler is available; every
entry point has a pure-Python fallback (bgzf.py), so the engine runs with or
without the native layer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libbgzf_mt.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and os.path.exists(
            os.path.join(_NATIVE_DIR, "Makefile")):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                           timeout=120, check=False)
        except Exception:  # noqa: BLE001
            pass
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.bgzf_scan_blocks.restype = ctypes.c_longlong
    lib.bgzf_scan_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.c_uint), ctypes.c_size_t,
    ]
    lib.bgzf_decompress_blocks.restype = ctypes.c_int
    lib.bgzf_decompress_blocks.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_uint),
        ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.bgzf_compress_chunks.restype = ctypes.c_longlong
    lib.bgzf_compress_chunks.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint), ctypes.c_size_t, ctypes.c_int,
    ]
    lib.bgzf_worst_block_size.restype = ctypes.c_size_t
    lib.bgzf_worst_block_size.argtypes = []
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def decompress_bgzf_bytes(data: bytes, n_threads: int | None = None) -> bytes | None:
    """Parallel-decompress a whole BGZF byte string; None -> caller falls back."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    max_blocks = len(data) // 28 + 2
    offsets = (ctypes.c_ulonglong * max_blocks)()
    csizes = (ctypes.c_uint * max_blocks)()
    usizes = (ctypes.c_uint * max_blocks)()
    n = lib.bgzf_scan_blocks(data, len(data), offsets, csizes, usizes, max_blocks)
    if n < 0:
        return None
    usz = np.frombuffer(usizes, dtype=np.uint32, count=n)
    out_offsets_np = np.zeros(n, dtype=np.uint64)
    if n > 1:
        out_offsets_np[1:] = np.cumsum(usz[:-1], dtype=np.uint64)
    total = int(usz.sum())
    out = ctypes.create_string_buffer(total)
    out_offsets = (ctypes.c_ulonglong * n)(*out_offsets_np.tolist())
    rc = lib.bgzf_decompress_blocks(data, offsets, csizes, out_offsets, usizes,
                                    n, out, n_threads)
    if rc != 0:
        return None
    return out.raw


def compress_bgzf_bytes(data: bytes, level: int = 6,
                        n_threads: int | None = None) -> bytes | None:
    """Parallel-compress payload into BGZF members (without EOF marker)."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    worst = lib.bgzf_worst_block_size()
    n_blocks = (len(data) + 65280 - 1) // 65280 if data else 0
    if n_blocks == 0:
        return b""
    out = ctypes.create_string_buffer(n_blocks * worst)
    sizes = (ctypes.c_uint * n_blocks)()
    n = lib.bgzf_compress_chunks(data, len(data), level, out, sizes, worst,
                                 n_threads)
    if n < 0:
        return None
    view = np.frombuffer(out, dtype=np.uint8, count=n_blocks * worst)
    parts = [view[i * worst : i * worst + sizes[i]] for i in range(n)]
    return np.concatenate(parts).tobytes()
