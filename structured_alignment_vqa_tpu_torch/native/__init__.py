"""Native (C++) tar indexer, loaded through ctypes: the port's own binding of
its copy of the TPU package's ``native/tar_index.cpp``.

The shared library is built with g++ at first use, never at import, into
``build/`` at the root of the checkout (beside the CUDA libraries of
``ops/_build.py``), keyed by a hash of the source so an edited source is
rebuilt. Without g++, :func:`tar_index.available` is False and
``data/tar_reader.py`` indexes with the pure-Python scanner, as the TPU
package does. This is host code: it runs on no device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

_SRC = Path(__file__).resolve().parent / "tar_index.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtarindex-{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = library_path()
        if not path.exists() and not _build(path):
            _failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.tar_index_build.restype = ctypes.c_void_p
        lib.tar_index_build.argtypes = [ctypes.c_char_p]
        lib.tar_index_count.restype = ctypes.c_int64
        lib.tar_index_count.argtypes = [ctypes.c_void_p]
        lib.tar_index_entry.restype = ctypes.c_int
        lib.tar_index_entry.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tar_index_free.restype = None
        lib.tar_index_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class tar_index:
    """Namespace matching the import in ``data/tar_reader.py``."""

    @staticmethod
    def available() -> bool:
        return _load() is not None

    @staticmethod
    def index_tar(path: str) -> List[Tuple[str, int, int]]:
        lib = _load()
        if lib is None:
            raise RuntimeError("native tar indexer unavailable (no g++ to build it)")
        handle = lib.tar_index_build(path.encode())
        if not handle:
            raise IOError(f"cannot index {path}")
        try:
            n = lib.tar_index_count(handle)
            out = []
            name = ctypes.c_char_p()
            off = ctypes.c_uint64()
            size = ctypes.c_uint64()
            for i in range(n):
                if lib.tar_index_entry(handle, i, ctypes.byref(name),
                                       ctypes.byref(off), ctypes.byref(size)) == 0:
                    out.append((name.value.decode(), int(off.value), int(size.value)))
            return out
        finally:
            lib.tar_index_free(handle)
