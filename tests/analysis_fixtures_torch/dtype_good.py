"""GOOD: f32/bf16 compute, plus one justified f64 suppression (the
twin of analysis_fixtures/dtype_good.py)."""

import numpy as np
import torch


def narrow(x):
    a = torch.zeros(4, dtype=torch.float32)
    b = torch.as_tensor(np.asarray(x), dtype=torch.bfloat16)
    # pio: lint-ignore[dtype-discipline]: exact oracle solve needs f64 conditioning; host-side only
    c = torch.eye(4, dtype=torch.float64)
    return a, b, c
