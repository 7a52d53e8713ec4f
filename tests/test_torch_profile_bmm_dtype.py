"""``pio train --profile`` counts the FLOPs of ALS's bf16 products with an
f32 result (``torch.bmm(a, b, out_dtype=torch.float32)``, the
``bmm.dtype`` overload that ``ops/als._bmm_f32`` takes on the card).

torch's own ``bmm`` FLOP formula takes that overload's third positional
argument for its ``out_shape`` and raises ``TypeError: bmm_flop() got
multiple values for argument 'out_shape'``, so a profiled ALS training run
on the card died in its first half-step (`pio train --profile` of the
recommendation walk-through exited 1), where the JAX package's profiled
run of the same engine completes. ``obs/device.count_flops`` now counts
``aten.bmm`` with a formula that accepts it. Meta tensors run the card's
overload here, on the CPU, without a card.
"""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from predictionio_tpu_torch.obs import device as obs_device

SHAPES = [((3, 4, 5), (3, 5, 6)), ((1, 32, 32), (1, 32, 1)), ((7, 1, 200), (7, 200, 200))]


def _profiled_flops(run) -> float:
    profiler = obs_device.TrainProfiler()
    profiler.begin(None)
    try:
        with obs_device.count_flops():
            run()
    finally:
        profiler.finish(None)
    return profiler._flops


@pytest.mark.parametrize("a_shape, b_shape", SHAPES)
def test_bf16_product_with_f32_result_is_counted(a_shape, b_shape):
    a = torch.empty(a_shape, dtype=torch.bfloat16, device="meta")
    b = torch.empty(b_shape, dtype=torch.bfloat16, device="meta")
    flops = _profiled_flops(lambda: torch.bmm(a, b, out_dtype=torch.float32))
    batch, m, k = a_shape
    assert flops == 2 * batch * m * b_shape[2] * k


@pytest.mark.parametrize("a_shape, b_shape", SHAPES)
def test_plain_product_is_counted_as_torch_counts_it(a_shape, b_shape):
    a, b = torch.randn(a_shape), torch.randn(b_shape)
    with FlopCounterMode(display=False) as torch_counter:
        torch.bmm(a, b)
    assert _profiled_flops(lambda: torch.bmm(a, b)) == torch_counter.get_total_flops()
