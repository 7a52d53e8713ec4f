"""Native runtime components (C++, bound with ctypes; a copy of the JAX
package's ``native/`` event-log part).

:func:`load_eventlog` returns the compiled event-log library
(``eventlog.cc``: the binevents codec and its filtered scan) or None when
it cannot be built — callers fall back to the pure-Python codec in
``storage/binevents.py``, which reads and writes the identical byte
format. That quiet fallback keeps the package usable where no ``g++``
exists; ``chip_smoke.py`` checks that the native scanner served its read.

The library is built with ``g++`` at first use into ``build/native/``
beside the package (git-ignored), never next to the source. The file
name carries a hash of the source and the flags, so an edited source
builds anew; a build goes to a per-process temporary file and is renamed
into place, so two processes racing on first use never load a partly
written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "eventlog.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libeventlog-{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> Path | None:
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass
        return None


def load_eventlog() -> ctypes.CDLL | None:
    """Build (if needed) and load the native event log; None on failure."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so = _build(library_path())
        if so is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _load_failed = True
            return None
        c_char_pp = ctypes.POINTER(ctypes.c_char_p)
        u8_pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        u64_p = ctypes.POINTER(ctypes.c_uint64)
        lib.pio_open.argtypes = [ctypes.c_char_p]
        lib.pio_open.restype = ctypes.c_void_p
        lib.pio_close.argtypes = [ctypes.c_void_p]
        lib.pio_close.restype = ctypes.c_int
        lib.pio_flush.argtypes = [ctypes.c_void_p]
        lib.pio_flush.restype = ctypes.c_int
        lib.pio_write_put.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.pio_write_put.restype = ctypes.c_int
        lib.pio_write_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pio_write_del.restype = ctypes.c_int
        lib.pio_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p, c_char_pp,
            ctypes.c_int32, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, u8_pp, u64_p,
        ]
        lib.pio_scan.restype = ctypes.c_int
        lib.pio_get.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u8_pp, u64_p]
        lib.pio_get.restype = ctypes.c_int
        lib.pio_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.pio_free.restype = None
        _lib = lib
        return _lib
