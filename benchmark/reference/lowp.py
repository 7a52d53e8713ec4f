"""Rounding of matrix-product operands to a lower precision, for the
controls: the plain references computed with their operands rounded to
the precision below the one a configuration states. The products still
run in float32 or float64; only the operands lose bits, which is what a
lower-precision path of the program would do to them.
"""

from __future__ import annotations

import torch

#: the largest finite value of float8 e4m3
_E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), returned in ``x``'s dtype."""
    scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


def exact(x: torch.Tensor) -> torch.Tensor:
    return x
