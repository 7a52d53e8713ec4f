"""Native runtime components (C++, bound with ctypes; a copy of the JAX
package's ``native/``).

:func:`load_eventlog` returns the compiled event-log library
(``eventlog.cc``: the binevents codec and its filtered scan) or None when
it cannot be built — callers fall back to the pure-Python codec in
``storage/binevents.py``, which reads and writes the identical byte
format. :func:`load_bucketize` returns the ratings packer
(``bucketize.cc``: ``pio_ladder``, ``pio_bucketize`` and ``pio_chunk``,
the three ALS layouts, behind the ``pio_bucketize_*`` and ``pio_chunk_*``
handle calls) or None — ``ops/als.ladder_rows``, ``bucket_rows`` and
``chunk_rows`` then pack in NumPy, which builds the same slabs. Those quiet fallbacks keep
the package usable where no ``g++`` exists; ``chip_smoke.py`` checks
that the native scanner and the native packer served.

A library is built with ``g++`` at first use into ``build/native/``
beside the package (git-ignored), never next to the source. The file
name carries the library's name and a hash of the source and the flags,
so an edited source builds anew; a build goes to a per-process
temporary file and is renamed into place, so two processes racing on
first use never load a partly written library. Each build is one
compile event of the build sentinel (``obs/compile.record_build``); a
load of a built library is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from predictionio_tpu_torch.obs.compile import record_build

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def library_path(name: str = "eventlog") -> Path:
    """Where ``<name>.cc`` builds: ``build/native/lib<name>-<hash>.so``."""
    digest = hashlib.sha256((_DIR / f"{name}.cc").read_bytes()
                            + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str) -> Path | None:
    so = library_path(name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
    src = _DIR / f"{name}.cc"
    try:
        t0 = time.perf_counter()
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        record_build(name, src, t0, time.perf_counter())
        return so
    except (OSError, subprocess.SubprocessError):
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass
        return None


def _load(name: str, bind) -> ctypes.CDLL | None:
    """Build (if needed), load and bind ``<name>.cc`` once per process;
    None, remembered, when any step fails."""
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        so = _build(name)
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
                bind(lib)
            except (OSError, AttributeError):
                lib = None
        _libs[name] = lib
        return lib


def _bind_eventlog(lib: ctypes.CDLL) -> None:
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


def _bind_bucketize(lib: ctypes.CDLL) -> None:
    """The three layout entry points (``pio_ladder``, ``pio_bucketize``,
    ``pio_chunk``) and their handle calls. A library without one of these
    symbols raises AttributeError: no native path."""
    i32_p = ctypes.POINTER(ctypes.c_int32)
    i64_p = ctypes.POINTER(ctypes.c_int64)
    f32_p = ctypes.POINTER(ctypes.c_float)
    coo = [ctypes.c_int64, i32_p, i32_p, f32_p, ctypes.c_int32]   # nnz, rows, cols, vals, num_rows
    lib.pio_ladder.argtypes = coo + [ctypes.c_int32, ctypes.c_int32, i64_p, ctypes.c_int32]
    lib.pio_ladder.restype = ctypes.c_void_p
    lib.pio_bucketize.argtypes = coo + [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.pio_bucketize.restype = ctypes.c_void_p
    lib.pio_chunk.argtypes = coo + [i32_p, ctypes.c_int32]
    lib.pio_chunk.restype = ctypes.c_void_p
    # one handle contract for both handle kinds: count, shape, fill, free
    for num, info, fill, free in (
            (lib.pio_bucketize_num_buckets, lib.pio_bucketize_bucket_info,
             lib.pio_bucketize_fill, lib.pio_bucketize_free),
            (lib.pio_chunk_num_slabs, lib.pio_chunk_slab_info, lib.pio_chunk_fill,
             lib.pio_chunk_free)):
        num.argtypes = [ctypes.c_void_p]
        num.restype = ctypes.c_int32
        info.argtypes = [ctypes.c_void_p, ctypes.c_int32, i32_p, i64_p]
        info.restype = ctypes.c_int
        fill.argtypes = [ctypes.c_void_p, ctypes.c_int32, i32_p, i32_p, f32_p, i32_p]
        fill.restype = ctypes.c_int
        free.argtypes = [ctypes.c_void_p]
        free.restype = None


def load_eventlog() -> ctypes.CDLL | None:
    """Build (if needed) and load the native event log; None on failure."""
    return _load("eventlog", _bind_eventlog)


def load_bucketize() -> ctypes.CDLL | None:
    """Build (if needed) and load the native ratings packer; None on
    failure."""
    return _load("bucketize", _bind_bucketize)
