"""``mfu.serve-long`` (%): the forward FLOPs that the traced window's
queries need (``roofline/moe_seqrec.py``: the GQA projections, the
router, the top-k SwiGLU experts and attention over the real causal
pairs, clipped to the window on sliding layers, of the real tokens; the
head of the last position), over the window's seconds, over the card's
bf16 dense peak."""

from benchmark.roofline.moe_seqrec import batch_forward_flops


def read(outcome):
    facts = outcome.facts
    if outcome.trace is None or facts.get("window_s", 0) <= 0:
        return None
    flops = sum(batch_forward_flops(outcome.config, lengths)
                for lengths in facts["batch_lengths"])
    return 100.0 * flops / facts["window_s"] / outcome.peaks["bf16_flops"]
