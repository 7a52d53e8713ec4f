"""ALS training through the recommendation template: whole
``ALSAlgorithm.train(ctx, pd)`` calls back to back, each the template's
``numIterations`` from the starting table it draws from its ``seed``.

Set-up makes the ratings from the run's seed and builds the prepared
data once, as ``ALSPreparator`` would (dense ids, seen items), short of
the event store; then one warm-up call of ``warmup_iterations``. Each
call packs its layout, stages it and iterates, as ``pio train`` does.

End to end: ``train_step_ms``, the window over its iterations: the
window runs from the first call's start to the end of the last call that
started before ``--seconds`` was up, each call ending when the card has
finished it. A ``--trace 1`` run profiles the window's first
``trace_calls`` calls; its per-layer metrics are of those calls.

The check, after the window and with the calls' staging freed: the
factor tables of every call in the window against the plain reference
(``reference/als.py``) run from the same ratings and the same starting
table: ``factor_gap``, the worst row over both tables and every call.
"""

from __future__ import annotations

import inspect
import time

import numpy as np

from benchmark.harness.runner import Outcome, RunSpec, log
from benchmark.inputs import als as inputs
from benchmark.reference import als as reference


def prepared_data(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, cfg: dict):
    """The template's ``PreparedData``: id ``str(i)`` is dense index i."""
    from predictionio_tpu_torch.ops.als import RatingsCOO
    from predictionio_tpu_torch.templates.recommendation import PreparedData
    from predictionio_tpu_torch.utils.bimap import BiMap, EntityIdIxMap

    def ids(n: int) -> EntityIdIxMap:
        return EntityIdIxMap(BiMap({str(i): i for i in range(n)}))

    return PreparedData(
        coo=RatingsCOO(rows=rows, cols=cols, vals=vals, num_rows=cfg["users"],
                       num_cols=cfg["items"]),
        user_ids=ids(cfg["users"]),
        item_ids=ids(cfg["items"]),
        seen_by_user=inputs.seen_by_row(rows, cols, cfg["users"]),
    )


def algorithm(cfg: dict, iterations: int, seed: int):
    from predictionio_tpu_torch.templates.recommendation import (
        ALSAlgorithm,
        ALSAlgorithmParams,
    )

    from predictionio_tpu_torch.ops.als import als_train

    # the template trains with als_train's defaults for what its params
    # do not carry; the configuration states them, so they must agree
    defaults = inspect.signature(als_train).parameters
    for key in ("matmul_dtype", "layout"):
        if defaults[key].default != cfg[key]:
            raise ValueError(f"the configuration states {key}={cfg[key]!r}; the template "
                             f"trains with {defaults[key].default!r}")
    return ALSAlgorithm(ALSAlgorithmParams(rank=cfg["rank"], num_iterations=iterations,
                                           lambda_=cfg["lambda"], seed=seed))


def run(spec: RunSpec) -> Outcome:
    import torch

    from predictionio_tpu_torch.workflow.context import EngineContext

    cfg, mix = spec.cell.config, spec.cell.traffic
    dev = spec.device
    rows, cols, vals = inputs.make_ratings(mix, cfg, spec.seed)
    log(spec, f"{len(rows)} ratings made")
    pd = prepared_data(rows, cols, vals, cfg)
    log(spec, "prepared data built")
    ctx = EngineContext(device=dev, devices=[dev])
    seed = inputs.item_seed(spec.seed)
    iterations = int(mix["iterations"])
    algorithm(cfg, int(mix["warmup_iterations"]), seed).train(ctx, pd)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - spec.started
    log(spec, "warmed up; window opens")

    algo = algorithm(cfg, iterations, seed)
    calls = []             # (start, end, user table, item table)

    def call() -> None:
        t0 = time.perf_counter()
        with spec.trace.span("train"):
            model = algo.train(ctx, pd)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        calls.append((t0, time.perf_counter(), model.user_factors, model.item_factors))
        log(spec, f"call {len(calls)}: {calls[-1][1] - t0:.3f} s")

    # a traced run profiles its first ``trace_calls`` calls (a call is
    # some 330,000 launches, and reading their trace takes longer than
    # the calls); the window then goes on untraced to its end
    traced = int(mix["trace_calls"]) if spec.trace.enabled else None
    with spec.trace:           # the window opens once the profiler is up
        first = time.perf_counter()
        deadline = first + spec.seconds
        while not calls or (time.perf_counter() < deadline
                            and (traced is None or len(calls) < traced)):
            call()
    while time.perf_counter() < deadline:
        call()
    window_s = calls[-1][1] - first
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the reference's own ratings and starting table, from the seed
    del pd
    rows, cols, vals = inputs.make_ratings(mix, cfg, spec.seed)
    item0 = reference.starting_items(cfg["items"], cfg["rank"], seed)
    with torch.inference_mode():
        user_ref, item_ref = reference.train(rows, cols, vals, cfg["users"], cfg["items"],
                                             item0, iterations, cfg["lambda"], dev)
        gap = max(max(reference.worst_row_gap(u, user_ref), reference.worst_row_gap(i, item_ref))
                  for _, _, u, i in calls)
    log(spec, f"reference done; factor_gap {gap}")
    n_iter = len(calls) * iterations
    return Outcome(
        attempted=len(calls),
        failed=0,
        end_to_end={"setup_s": setup_s, "train_step_ms": window_s * 1e3 / n_iter},
        facts={
            "iterations": (traced or len(calls)) * iterations,
        },
        readings={"factor_gap": gap},
        memory_peak_bytes=memory_peak,
        config=cfg,
    )
