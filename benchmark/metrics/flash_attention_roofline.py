"""``flash_attention_roofline`` (%): the flash-attention launches' least
time over their measured device time, in the traced window.

The least time is the sum, over the window's batches and the model's
layers, of ``roofline/attention.py``'s bound for one causal launch over
the real rows of the batch, from the real lengths the benchmark
generated (capped at the ``padded_len`` positions the program serves):
padded rows and tiles are not work the answer needs. The measured time
is the device time of the kernels whose name holds "flash". Nothing to
read (no trace, or no such kernel ran): no value.
"""

from benchmark.roofline.attention import bound_s


def _is_attention(name: str) -> bool:
    return "flash" in name.lower()


def read(outcome):
    if outcome.trace is None:
        return None
    measured = outcome.trace.device_seconds(_is_attention)
    if measured <= 0:
        return None
    cfg, facts = outcome.config, outcome.facts
    heads, dh = cfg["n_heads"], cfg["d_model"] // cfg["n_heads"]
    least = sum(bound_s(facts["padded_len"], heads, dh, lengths, outcome.peaks)[0]
                for lengths in facts["batch_lengths"]) * cfg["n_layers"]
    return 100.0 * least / measured
