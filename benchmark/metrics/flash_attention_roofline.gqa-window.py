"""``flash_attention_roofline.gqa-window`` (%): the MoE model's flash
launches' least time over their measured device time, in the traced
window.

The least time is the sum, over the window's batches and the model's
layers, of ``roofline/moe_seqrec.flash_launch``'s bound for one layer's
launch over the batch's real rows: 4·D FLOPs per real causal pair per
query head (pairs clipped to the window on sliding layers), bytes of q
and the output at the query heads and of k and v at the KV heads. Padded
rows and tiles are not work the answer needs. The measured time is the
device time of the kernels whose name holds "flash". Nothing to read (no
trace, or no such kernel ran): no value.
"""

from benchmark.roofline.moe_seqrec import _layers, flash_launch, least_s


def read(outcome):
    if outcome.trace is None:
        return None
    measured = outcome.trace.device_seconds(lambda name: "flash" in name.lower())
    if measured <= 0:
        return None
    cfg = outcome.config
    least = sum(least_s(flash_launch(cfg, kind, lengths), outcome.peaks)
                for lengths in outcome.facts["batch_lengths"] for kind in _layers(cfg))
    return 100.0 * least / measured
