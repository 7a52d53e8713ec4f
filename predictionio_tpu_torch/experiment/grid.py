"""Parallel grid evaluation: per-point eval worker processes (port of the
JAX package's ``experiment/grid.py``).

Grid points are embarrassingly parallel — each point trains and scores
its own fold set through ``engine.batch_eval`` with no shared state —
so ``pio eval --parallel N`` fans them over N short-lived child
processes riding the :class:`~predictionio_tpu_torch.fleet.supervisor.ProcessHandle`
discipline. The contract the tests pin:

- **per-point fault isolation** — a crashed (or poisoned) grid point
  becomes ONE ``FAILED`` point result carrying the child's exit code and
  its error; the rest of the grid completes and the best point is picked
  over the survivors. A grid is only lost when EVERY point fails.
- **deterministic order** — results are assembled by grid index, not
  completion order, so the evaluation-instance JSON is reproducible
  regardless of scheduling.
- **streaming** — the caller's ``on_point`` hook fires as each point
  lands, which is how workflow/evaluation.py makes the partial grid
  visible in the metadata store mid-run.

Children hand results back through single-use JSON spool files written
atomically (``os.replace``) under a per-run temp dir; a child that dies
mid-write leaves a ``.tmp`` orphan, never a torn result. A child that
raises also spools its error (``<point>.err``), which the parent appends
to the point's error text.

The children are forked, as in the JAX package, so the evaluation, the
engine and the storage reach them without pickling. On the card that
has one condition: CUDA must not be initialized in the parent, because a
forked child cannot use a CUDA context its parent made.
:func:`run_parallel_grid` raises before forking when the grid's device
is ``cuda`` and the parent has initialized CUDA; the port's device
resolution (``utils/device.resolve_device``) asks NVML, not CUDA,
whether a card is present, so a ``pio eval`` process forks clean and
each child initializes CUDA for itself. A child that cannot reach the
card becomes a ``FAILED`` point carrying its CUDA error; nothing falls
back to the CPU.

The fan-out only applies when the evaluator is a
:class:`~predictionio_tpu_torch.controller.evaluation.MetricEvaluator`
(children ship plain metric scores, not live ``EvalDataSet`` objects);
a custom evaluator takes the sequential path with a warning. The
sequential path is also what keeps
:class:`~predictionio_tpu_torch.controller.fast_eval.FastEvalEngine`'s
prefix sharing ACROSS points.

The points finished in this process are counted by outcome
(:func:`eval_point_counts`) and exported as ``pio_eval_points_total``
by :func:`eval_points_collector`. The JAX package registers that
collector on its router's ``/metrics`` (ROADMAP.md queue 1 item 23); the
port exports it and registers it nowhere yet. It reads a Python counter
and touches no CUDA, so a scrape cannot stop this process from forking.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import multiprocessing
import os
import tempfile
import threading
import time
from typing import Any, Callable, Sequence

import torch

from predictionio_tpu_torch.controller.evaluation import (
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
    MetricScores,
)
from predictionio_tpu_torch.controller.params import EngineParams
from predictionio_tpu_torch.fleet.supervisor import ProcessHandle
from predictionio_tpu_torch.obs.registry import Metric

logger = logging.getLogger(__name__)

#: point statuses (mirrors the evaluation-instance status vocabulary)
COMPLETED, FAILED = "COMPLETED", "FAILED"

#: how long the parent waits on any single child exit before re-polling
#: the whole set (bounded join)
_JOIN_SLICE_S = 0.05

_counts_lock = threading.Lock()
_point_counts: dict[str, int] = {COMPLETED: 0, FAILED: 0}


def _count_point(status: str) -> None:
    with _counts_lock:
        _point_counts[status] = _point_counts.get(status, 0) + 1


def eval_point_counts() -> dict[str, int]:
    """Grid points finished in this process, by status (what the JAX
    package's ``eval_points_collector`` exports)."""
    with _counts_lock:
        return dict(_point_counts)


def eval_points_collector() -> list[Metric]:
    """``pio_eval_points_total{status}``: grid points evaluated in this
    process, by outcome (the JAX package's family)."""
    with _counts_lock:
        samples = [({"status": s.lower()}, float(n))
                   for s, n in sorted(_point_counts.items())]
    return [Metric("pio_eval_points_total", "counter",
                   "Evaluation grid points finished, by status.",
                   samples=samples)]


@dataclasses.dataclass
class GridPointResult:
    """One grid point's outcome, in grid order."""

    idx: int
    status: str  # COMPLETED | FAILED
    score: Any = None
    other_scores: list[Any] = dataclasses.field(default_factory=list)
    error: str = ""
    duration_s: float = 0.0

    def to_doc(self) -> dict[str, Any]:
        doc: dict[str, Any] = {"idx": self.idx, "status": self.status,
                               "score": self.score,
                               "otherScores": self.other_scores,
                               "durationS": round(self.duration_s, 3)}
        if self.error:
            doc["error"] = self.error
        return doc


def _json_safe(value: Any) -> Any:
    """Scores cross the process boundary as JSON; anything exotic a
    custom metric returns degrades to ``str`` rather than killing the
    point on the way home."""
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return str(value)


def _spool(path: str, write: Callable[[Any], None]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        write(f)
    os.replace(tmp, path)


def _eval_point_child(evaluation: Evaluation, evaluator: MetricEvaluator,
                      ctx: Any, idx: int, engine_params: EngineParams,
                      out_path: str) -> None:
    """Child body: evaluate ONE grid point, spool the scores, exit.
    Raising spools the error and propagates to a nonzero exitcode, which
    the parent folds into a FAILED point result — fault isolation is the
    parent's job, the child just dies honestly."""
    started = time.monotonic()
    # the OpenMP pool of a parent that ran CPU ops does not survive the
    # fork (a parallel region would wait on its threads forever); one
    # intra-op thread a worker, as torch's own DataLoader workers take
    torch.set_num_threads(1)
    try:
        pairs = evaluation.engine.batch_eval(ctx, [engine_params])
        if not pairs:
            raise RuntimeError(f"batch_eval returned no data for point {idx}")
        _, eval_data = pairs[0]
        doc = {
            "idx": idx,
            "score": _json_safe(evaluator.metric.calculate(eval_data)),
            "otherScores": [_json_safe(m.calculate(eval_data))
                            for m in evaluator.other_metrics],
            "durationS": time.monotonic() - started,
        }
    except BaseException as exc:
        _spool(out_path + ".err", lambda f: f.write(f"{type(exc).__name__}: {exc}"))
        raise
    _spool(out_path, lambda f: json.dump(doc, f))


def _collect_point(idx: int, exitcode: int | None, out_path: str,
                   started: float) -> GridPointResult:
    duration = time.monotonic() - started
    if exitcode == 0 and os.path.exists(out_path):
        try:
            with open(out_path) as f:
                doc = json.load(f)
            return GridPointResult(
                idx=idx, status=COMPLETED, score=doc.get("score"),
                other_scores=list(doc.get("otherScores") or []),
                duration_s=float(doc.get("durationS") or duration))
        except (OSError, ValueError) as exc:
            return GridPointResult(
                idx=idx, status=FAILED, duration_s=duration,
                error=f"unreadable point result: {exc}")
    error = (f"eval worker exited with code {exitcode}"
             + ("" if os.path.exists(out_path) else " (no result spooled)"))
    try:
        with open(out_path + ".err") as f:
            error += f": {f.read()}"
    except OSError:
        pass
    return GridPointResult(idx=idx, status=FAILED, duration_s=duration, error=error)


def check_fork_safe(ctx: Any) -> None:
    """Raise when grid children on ``ctx``'s device could not use it: the
    device is ``cuda`` and this process has initialized CUDA already."""
    device = getattr(ctx, "device", None)
    if (device is not None and torch.device(device).type == "cuda"
            and torch.cuda.is_initialized()):
        raise RuntimeError(
            "CUDA is already initialized in this process, and a forked grid worker "
            "cannot use the card then: run the parallel grid (pio eval --parallel N) "
            "from a process that has not touched CUDA, or run it with parallel=1")


def run_parallel_grid(
    evaluation: Evaluation,
    evaluator: MetricEvaluator,
    params_list: Sequence[EngineParams],
    ctx: Any,
    parallel: int,
    on_point: Callable[[GridPointResult, int, int], None] | None = None,
) -> list[GridPointResult]:
    """Fan the grid over ``parallel`` eval worker processes; returns
    per-point results in grid-index order (module docstring has the
    isolation/ordering/streaming contract). ``on_point(result, done,
    total)`` fires after each point lands, in COMPLETION order."""
    check_fork_safe(ctx)
    total = len(params_list)
    width = max(1, min(int(parallel), total))
    # fork shares the evaluation/engine/storage objects without pickling
    mp = multiprocessing.get_context("fork")
    results: dict[int, GridPointResult] = {}
    pending = list(enumerate(params_list))
    live: dict[int, tuple[ProcessHandle, str, float]] = {}
    done = 0

    with tempfile.TemporaryDirectory(prefix="pio-eval-grid-") as spool:
        def _spawn(idx: int, ep: EngineParams) -> None:
            out_path = os.path.join(spool, f"point_{idx}.json")
            handle = ProcessHandle(mp.Process(
                target=_eval_point_child,
                args=(evaluation, evaluator, ctx, idx, ep, out_path),
                name=f"pio-eval-point-{idx}", daemon=True))
            live[idx] = (handle, out_path, time.monotonic())

        try:
            while pending or live:
                while pending and len(live) < width:
                    idx, ep = pending.pop(0)
                    _spawn(idx, ep)
                # bounded join on the oldest child, then sweep ALL
                # exits — one slow point never serializes collection
                oldest = min(live, key=lambda i: live[i][2])
                live[oldest][0].wait(timeout=_JOIN_SLICE_S)
                for idx in [i for i, (h, _, _) in live.items()
                            if h.poll() is not None]:
                    handle, out_path, started = live.pop(idx)
                    result = _collect_point(
                        idx, handle.poll(), out_path, started)
                    results[idx] = result
                    done += 1
                    _count_point(result.status)
                    if result.status == FAILED:
                        logger.warning("grid point %d FAILED: %s",
                                       idx, result.error)
                    else:
                        logger.info("grid point %d/%d: score=%s",
                                    idx, total, result.score)
                    if on_point is not None:
                        on_point(result, done, total)
        finally:
            for handle, _, _ in live.values():
                handle.kill()
                handle.wait(timeout=5.0)

    return [results[i] for i in sorted(results)]


def result_from_points(
    evaluator: MetricEvaluator,
    params_list: Sequence[EngineParams],
    points: Sequence[GridPointResult],
    evaluation: Evaluation | None = None,
) -> MetricEvaluatorResult:
    """Reassemble a :class:`MetricEvaluatorResult` from per-point
    results: ``engine_params_scores`` covers EVERY grid point in order
    (failed points carry a ``None`` score so downstream indices line
    up with the grid), while best-tracking only compares survivors.
    Raises when every point failed — a grid with no surviving point
    has no result to persist, and the caller records FAILED."""
    scores: list[tuple[EngineParams, MetricScores]] = []
    best_idx = -1
    for point in points:
        ms = MetricScores(score=point.score,
                          other_scores=list(point.other_scores))
        scores.append((params_list[point.idx], ms))
        if point.status != COMPLETED:
            continue
        if best_idx < 0 or evaluator.metric.compare(
                ms.score, scores[best_idx][1].score) > 0:
            best_idx = point.idx
    if best_idx < 0:
        raise RuntimeError(
            "every grid point failed: "
            + "; ".join(f"[{p.idx}] {p.error}" for p in points))
    best_params, best_score = scores[best_idx]
    result = MetricEvaluatorResult(
        best_score=best_score,
        best_engine_params=best_params,
        best_idx=best_idx,
        metric_header=evaluator.metric.header,
        other_metric_headers=[m.header for m in evaluator.other_metrics],
        engine_params_scores=scores,
        output_path=evaluator.output_path,
    )
    if evaluator.output_path and evaluation is not None:
        evaluator._save_best_json(evaluation, best_params)
    return result


def partial_grid_doc(points: Sequence[GridPointResult],
                     total: int) -> str:
    """The mid-run evaluation-instance JSON: which points have landed
    (by grid index) and how many remain — readable while the grid is
    still running."""
    by_idx = sorted(points, key=lambda p: p.idx)
    return json.dumps({
        "gridTotal": total,
        "gridDone": len(by_idx),
        "points": [p.to_doc() for p in by_idx],
    }, indent=2)


def count_sequential_points(n_completed: int, failed: bool = False) -> None:
    """Fold the sequential path's outcome into the same counts the
    parallel path feeds."""
    for _ in range(max(0, n_completed)):
        _count_point(COMPLETED)
    if failed:
        _count_point(FAILED)
