"""The check that decides ``correct``: a sound tiny run is correct; the
control (the reference with its product operands in float8, the
precision below the configuration's bfloat16) reads above the cell's
limit; and a run whose timed path is broken underneath comes out not
correct, once for each fault the cell can have (one card: no exchange
between chips to leave out)."""

from __future__ import annotations

import contextlib

import bench_tiny
import pytest
import torch

from benchmark.tools import calibrate


@pytest.mark.parametrize("name", [bench_tiny.SERVE, bench_tiny.TRAIN])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, trace):
    line = bench_tiny.run_tiny(name, trace=trace)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in getattr(bench_tiny.load_cell(name), kind)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names


@pytest.mark.parametrize("name", [bench_tiny.SERVE, bench_tiny.TRAIN])
@pytest.mark.parametrize("trace", [False, True])
def test_a_window_shorter_than_one_call_still_measures_one(name, trace):
    line = bench_tiny.run_tiny(name, trace=trace, seconds=1e-6)
    assert line["correct"] is True and line["attempted"] >= 1, line


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_serve_control_fails_the_limit(seed):
    limit = bench_tiny.load_cell(bench_tiny.SERVE).limits["rank_gap"]
    reading = calibrate.serve_control(bench_tiny.tiny_cell(bench_tiny.SERVE), seed,
                                      torch.device("cpu"), batches=10)
    assert reading > limit


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_als_control_and_faults_fail_the_limit(seed):
    limit = bench_tiny.load_cell(bench_tiny.TRAIN).limits["factor_gap"]
    readings = calibrate.als_control(bench_tiny.tiny_cell(bench_tiny.TRAIN), seed,
                                     torch.device("cpu"))
    assert readings["control_fp8"] > limit, readings
    assert readings["fault_last_step_unchanged"] > limit, readings
    assert readings["fault_half_ratings"] > limit, readings


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _serve_faults():
    from predictionio_tpu_torch.models import seqrec

    def altered_answer(topk):            # an answer altered where it is produced
        def f(x, k):
            vals, ids = topk(x, k)
            return vals, torch.where(ids > 1, ids - 1, ids + 1)
        return f

    def half_batch(predict):             # half of the batch left out
        def f(model, history, k, masks, **kw):
            n = max(1, history.shape[0] // 2)
            vals, ids = predict(model, history[:n], k, masks[:n], **kw)
            reps = -(-history.shape[0] // n)
            return vals.repeat(reps, 1)[: history.shape[0]], ids.repeat(reps, 1)[: history.shape[0]]
        return f

    def unchanged_step(forward):         # a block that returns its state unchanged
        def f(self, x, mask, attention):
            return x if self is self.__class__._first else forward(self, x, mask, attention)
        return f

    return [
        lambda: _patched(seqrec, "topk_lowest_index", altered_answer),
        lambda: _patched(seqrec, "predict_topk_batch", half_batch),
        lambda: _first_block_unchanged(seqrec, unchanged_step),
    ]


@contextlib.contextmanager
def _first_block_unchanged(seqrec, unchanged_step):
    """Every model's first block returns its input: the first block built
    after the patch is remembered as the one to skip."""
    original_init = seqrec._Block.__init__

    def init(self, cfg, device):
        original_init(self, cfg, device)
        if getattr(seqrec._Block, "_first", None) is None:
            seqrec._Block._first = self

    seqrec._Block._first = None
    seqrec._Block.__init__ = init
    try:
        with _patched(seqrec._Block, "forward", unchanged_step):
            yield
    finally:
        seqrec._Block.__init__ = original_init
        del seqrec._Block._first


def _train_faults():
    from predictionio_tpu_torch.ops import als

    def unchanged_step(iterate):          # the last iteration returns its state unchanged
        def f(item0, ub, ib, iterations, *a, **kw):
            return iterate(item0, ub, ib, iterations - 1, *a, **kw)
        return f

    def half_ratings(ladder):             # half of each row's ratings left out
        def f(coo, *a, **kw):
            packed = ladder(coo, *a, **kw)
            for b in packed.buckets:
                b.deg[:] = (b.deg + 1) // 2
            return packed
        return f

    def altered_answer(solve):            # one solved row altered where it is produced
        def f(*a, **kw):
            out = solve(*a, **kw)
            out[0] += 1.0
            return out
        return f

    return [
        lambda: _patched(als, "_als_iterate_fused", unchanged_step),
        lambda: _patched(als, "ladder_rows", half_ratings),
        lambda: _patched(als, "_solve_half_buckets", altered_answer),
    ]


@pytest.mark.parametrize("fault", range(3), ids=["altered_answer", "half_batch",
                                                 "unchanged_step"])
def test_broken_serving_path_is_not_correct(fault):
    with _serve_faults()[fault]():
        line = bench_tiny.run_tiny(bench_tiny.SERVE)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", range(3), ids=["unchanged_step", "half_ratings",
                                                 "altered_answer"])
def test_broken_training_path_is_not_correct(fault):
    with _train_faults()[fault]():
        line = bench_tiny.run_tiny(bench_tiny.TRAIN)
    assert line["correct"] is False, line["checks"]


def test_a_failing_batch_counts_and_is_not_correct():
    from predictionio_tpu_torch.templates import sessionrec

    calls = []

    def every_third_fails(batch_predict):
        def f(self, model, queries):
            calls.append(1)
            if len(calls) % 3 == 0:
                raise RuntimeError("planted failure")
            return batch_predict(self, model, queries)
        return f

    with _patched(sessionrec.SeqRecAlgorithm, "batch_predict", every_third_fails):
        line = bench_tiny.run_tiny(bench_tiny.SERVE)
    assert 0 < line["failed"] < line["attempted"]
    assert line["correct"] is False
