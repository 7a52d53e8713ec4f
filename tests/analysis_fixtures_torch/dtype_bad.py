"""BAD: float64 on the compute path, in torch (the dtype_bad.py twin)."""

import numpy as np
import torch


def widen(x):
    a = torch.zeros(4, dtype=torch.float64)   # attribute dtype
    b = torch.as_tensor(x, dtype="float64")   # string dtype= keyword
    c = torch.from_numpy(np.asarray(x).astype("float64"))  # string astype
    d = torch.tensor(3.5).to(torch.float64)   # attribute in a cast
    return a, b, c, d
