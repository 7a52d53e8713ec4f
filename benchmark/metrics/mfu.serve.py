"""``mfu.serve`` (%): the forward FLOPs that the window's queries need
(``roofline/seqrec.py``: the real tokens' products, attention over real
causal pairs, the tied logits of the last position), over the traced
window's seconds, over the card's bf16 dense peak."""

from benchmark.roofline.seqrec import batch_forward_flops


def read(outcome):
    facts = outcome.facts
    if outcome.trace is None or facts["window_s"] <= 0:
        return None
    flops = sum(batch_forward_flops(outcome.config, lengths)
                for lengths in facts["batch_lengths"])
    return 100.0 * flops / facts["window_s"] / outcome.peaks["bf16_flops"]
