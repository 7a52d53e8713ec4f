"""Device resolution for every entry point of the port.

The default is the card: ``resolve_device()`` gives ``cuda``, and the
CPU is used only when the caller asks for it (the tests do). A missing
card raises instead of quietly running on the CPU.

Whether a card is present is asked of NVML (``torch.cuda.device_count``),
not of the CUDA runtime, so resolving the device does not initialize
CUDA in this process: a process that forks eval workers onto the card
(``experiment/grid.py``) must not have initialized CUDA itself.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``. Raises RuntimeError when CUDA is asked for
    and no card is present; initializes no CUDA context."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.device_count() == 0:
        raise RuntimeError(
            "CUDA was requested but torch.cuda.device_count() is 0; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def available_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """The devices a mesh may span: every card (``cuda:0`` ...) when
    ``device`` resolves to the card, else ``[cpu]``. The cards are
    counted by NVML, so no CUDA context is initialized."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def as_device_tensor(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``x`` (NumPy, a sequence or a tensor) as a ``dtype`` tensor on
    ``device``; ``device=None`` keeps a tensor where it is and puts
    anything else on the card."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=resolve_device(device))


@contextlib.contextmanager
def ieee_f32() -> Iterator[None]:
    """f32 matrix products in true f32 inside the block (the JAX
    package's ``Precision.HIGHEST``), whatever the process set for TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
