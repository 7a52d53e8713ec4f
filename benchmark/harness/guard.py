"""What a run must not have loaded, and where its caches go.

The benchmark measures the PyTorch port alone. After the window a run
looks in ``sys.modules`` for JAX, its libraries and the JAX package,
comparing each module's top-level name (the part before the first dot)
whole: ``predictionio_tpu_torch`` is the port and passes,
``predictionio_tpu`` is the JAX package and fails.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "predictionio_tpu"})


class ForbiddenImport(RuntimeError):
    pass


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default:
    ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def check_no_jax() -> None:
    found = forbidden_loaded()
    if found:
        raise ForbiddenImport(f"the run loaded {', '.join(found)}: the benchmark measures "
                              f"the PyTorch port alone")


def pin_caches(root: Path) -> None:
    """Point every build and kernel cache the program or torch may use at
    a fixed folder under the checkout's ``build/``, so that only the
    first run in a checkout builds; and keep libraries from loading JAX
    by themselves. Call before torch is imported."""
    build = root / "build"
    os.environ.update({
        "TRITON_CACHE_DIR": str(build / "triton"),
        "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
        "TORCHINDUCTOR_CACHE_DIR": str(build / "inductor"),
        "CUDA_CACHE_PATH": str(build / "cuda_cache"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
    })
