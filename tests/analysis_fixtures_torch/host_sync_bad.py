"""BAD: device→host syncs on the serving path, in torch (the twin of
analysis_fixtures/host_sync_bad.py, finding for finding and line for
line)."""

import numpy as np
import torch


def handle_query(model, query):
    scores = model.predict(query)
    best = scores.argmax().item()                 # sync per request
    confidence = float(torch.max(scores))         # hidden sync
    host_scores = np.asarray(torch.sort(scores).values)  # device copy-out
    torch.cuda.synchronize()                      # explicit barrier
    top = float(torch.sum(scores[:10]))           # forced transfer
    return best, confidence, host_scores, top
