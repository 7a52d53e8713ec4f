"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/kernels/`` next
to the package (git-ignored). The file name carries a hash of the source
and the flags, so an edited source builds anew and an unchanged one is
loaded as it is. ``build_all`` starts one ``nvcc`` per source, all at
once, for scripts that want every kernel ready before they time anything.
Each build is one compile event of the build sentinel
(``obs/compile.record_build``); a load of a built library is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from predictionio_tpu_torch.obs.compile import record_build

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)
_NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); "
                       "the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen, float] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc, t0


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen, t0: float) -> str:
    try:
        log, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out after {_NVCC_TIMEOUT_S}s on {name}.cu")
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    record_build(name, CSRC / f"{name}.cu", t0, time.perf_counter())
    return log


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named kernel (default: all of ``csrc/``) that is not
    built yet, one ``nvcc`` process per source, all started together.
    Returns the compiler's output (registers, shared memory, spills) per
    kernel built now."""
    names = kernel_names() if names is None else names
    with _lock:
        started = {n: s for n in names if (s := _start(n)) is not None}
        logs = {}
        try:
            for n, (out, tmp, proc, t0) in started.items():
                logs[n] = _finish(n, out, tmp, proc, t0)
        finally:
            for out, tmp, proc, _ in started.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        return logs


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
    return lib
