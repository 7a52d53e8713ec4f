"""GOOD: the serving path keeps tensors on the device; host conversion
of plain Python values stays legal (the twin of
analysis_fixtures/host_sync_good.py)."""

import numpy as np
import torch


def handle_query(model, query, headers):
    budget = float(headers.get("x-pio-deadline-ms", "0"))  # str, not device
    batch = np.asarray([query.user_id], dtype=np.int32)    # host list in
    return model.predict(torch.as_tensor(batch)), budget
