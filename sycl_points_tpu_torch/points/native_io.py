"""ctypes binding of the native host I/O library (``native/sycl_points_io.cpp``).

The port's own copy of :mod:`sycl_points_tpu.points.native_io`: fast PLY and
KITTI readers, a prefetching sequence loader (a reader thread parses scan
N+1 while scan N is processed) and the liblzf codec of binary_compressed PCD
files. Each falls back to the port's numpy readers (:mod:`.io`,
:mod:`.conversion`) when the library cannot be built.

The library is compiled at first use with ``g++ -O3 -std=c++17 -fPIC -pthread
-shared`` (``native/Makefile``'s flags) into ``sycl_points_tpu_torch/_build/``,
named by a hash of the source and the flags; ``native/`` is only read.
:func:`available` says whether it could be built and loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "sycl_points_io.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
READ_TIMEOUT_S = 60.0  # the longest the prefetching loader waits for one scan

_lib = None
_lib_lock = threading.Lock()


class _SptCloud(ctypes.Structure):
    _fields_ = [
        ("points", ctypes.POINTER(ctypes.c_float)),
        ("intensity", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("rgb", ctypes.POINTER(ctypes.c_float)),
        ("timestamps", ctypes.POINTER(ctypes.c_float)),
        ("n", ctypes.c_int64),
        ("ok", ctypes.c_int32),
        ("error", ctypes.c_char * 256),
    ]


def build_library() -> Optional[str]:
    """Compile the library unless one for this source and these flags
    exists; returns its path, or None when there is no source or compiler,
    or the compiler fails. The compiler is ``g++`` from ``PATH``, not
    ``$CXX``: a ``$CXX`` of another toolchain can link the library without
    the ``libstdc++`` the process loads, and its readers then crash."""
    cxx = shutil.which("g++")
    if cxx is None or not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libsycl_points_io_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        out = os.path.join(work, "lib.so")
        if subprocess.run([cxx, *CXX_FLAGS, "-o", out, SOURCE], capture_output=True).returncode != 0:
            return None
        os.replace(out, path)
    return path


def ensure_built() -> bool:
    """Build (if needed) and load the library once per process; returns
    whether it is available."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return True
        path = build_library()
        if path is None:
            return False
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return False
        lib.spt_read_ply.restype = ctypes.POINTER(_SptCloud)
        lib.spt_read_ply.argtypes = [ctypes.c_char_p]
        lib.spt_read_kitti_bin.restype = ctypes.POINTER(_SptCloud)
        lib.spt_read_kitti_bin.argtypes = [ctypes.c_char_p]
        lib.spt_free_cloud.argtypes = [ctypes.POINTER(_SptCloud)]
        lib.spt_free_cloud.restype = None
        lib.spt_loader_open.restype = ctypes.c_void_p
        lib.spt_loader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
        lib.spt_loader_next.restype = ctypes.POINTER(_SptCloud)
        lib.spt_loader_next.argtypes = [ctypes.c_void_p]
        lib.spt_loader_close.argtypes = [ctypes.c_void_p]
        lib.spt_loader_close.restype = None
        for fn in (lib.spt_lzf_decompress, lib.spt_lzf_compress):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                           ctypes.c_int64]
        _lib = lib
    return True


def available() -> bool:
    return ensure_built()


def _cloud_to_dict(ptr) -> Dict[str, np.ndarray]:
    c = ptr.contents
    if not c.ok:
        err = bytes(c.error).split(b"\0")[0].decode()
        _lib.spt_free_cloud(ptr)
        raise IOError(f"native reader failed: {err}")
    n = c.n
    out: Dict[str, np.ndarray] = {"points": np.ctypeslib.as_array(c.points, shape=(n, 3)).copy()}
    if c.intensity:
        out["intensities"] = np.ctypeslib.as_array(c.intensity, shape=(n,)).copy()
    if c.normals:
        out["normals"] = np.ctypeslib.as_array(c.normals, shape=(n, 3)).copy()
    if c.rgb:
        out["rgb"] = np.ctypeslib.as_array(c.rgb, shape=(n, 4)).copy()
    if c.timestamps:
        out["timestamp_offsets"] = np.ctypeslib.as_array(c.timestamps, shape=(n,)).copy()
    _lib.spt_free_cloud(ptr)
    return out


def read_ply(path: str) -> Dict[str, np.ndarray]:
    if not ensure_built():
        from sycl_points_tpu_torch.points import io

        return io.read_ply(path)
    return _cloud_to_dict(_lib.spt_read_ply(path.encode()))


def read_kitti_bin(path: str) -> Dict[str, np.ndarray]:
    if not ensure_built():
        from sycl_points_tpu_torch.points.conversion import read_kitti_bin as fallback

        return fallback(path)
    return _cloud_to_dict(_lib.spt_read_kitti_bin(path.encode()))


class PrefetchLoader:
    """A sequence loader whose reader thread parses scan N+1 from disk while
    the consumer processes scan N (``.ply`` or KITTI ``.bin``). Close it, or
    use it as a context manager."""

    def __init__(self, paths: Sequence[str], prefetch: int = 2):
        self.paths = list(paths)
        self._handle = None
        if ensure_built():
            self._keepalive = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._handle = _lib.spt_loader_open(self._keepalive, len(self.paths), prefetch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._handle:
            for path in self.paths:
                # the library's next() returns null, rather than wait, while
                # its reader thread still parses the last path it claimed:
                # poll until that scan arrives
                deadline = time.monotonic() + READ_TIMEOUT_S
                while not (ptr := _lib.spt_loader_next(self._handle)):
                    if time.monotonic() > deadline:
                        raise IOError(f"native loader: {path} not read within {READ_TIMEOUT_S} s")
                    time.sleep(1e-3)
                yield _cloud_to_dict(ptr)
        else:
            from sycl_points_tpu_torch.points import io
            from sycl_points_tpu_torch.points.conversion import read_kitti_bin

            for p in self.paths:
                yield io.read_file(p) if p.endswith(".ply") else read_kitti_bin(p)

    def close(self) -> None:
        if self._handle:
            _lib.spt_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- the liblzf codec (PCL binary_compressed PCD bodies) ------------------------


def _as_u8_ptr(buf: bytes):
    return ctypes.cast((ctypes.c_uint8 * len(buf)).from_buffer_copy(buf), ctypes.POINTER(ctypes.c_uint8))


def lzf_decompress(src: bytes, out_len: int) -> Optional[bytes]:
    """Native LZF decode; None when the library is unavailable. Raises
    ValueError on a corrupt stream."""
    if not ensure_built():
        return None
    out = (ctypes.c_uint8 * out_len)()
    got = _lib.spt_lzf_decompress(_as_u8_ptr(src), len(src), ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
                                  out_len)
    if got != out_len:
        raise ValueError(f"lzf: decompressed {got} bytes, expected {out_len}")
    return bytes(out)


def lzf_compress(src: bytes) -> Optional[bytes]:
    """Native LZF encode; None when the library is unavailable."""
    if not ensure_built():
        return None
    cap = len(src) + len(src) // 32 + 64  # every byte a literal: n + ceil(n / 32) control bytes
    out = (ctypes.c_uint8 * cap)()
    got = _lib.spt_lzf_compress(_as_u8_ptr(src), len(src), ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), cap)
    if got < 0:
        raise ValueError("lzf: compression output exceeded the worst-case bound")
    return bytes(out[:got])
