"""The sessionrec serve path's stage spans and their profiler mirror, on
the CPU.

``obs.trace.span`` (and ``Trace.span``) is also a ``torch.profiler``
annotation while a profiler records, so the template's and the model
step's stages appear on the profiler's timeline beside the device's
work:

- under a profiler, ``batch_predict`` yields one host annotation per
  stage, in code order and inside the caller's own annotation;
- with no trace bound and no profiler, ``span()`` is the shared no-op
  and ``record_function`` is never entered;
- with a trace bound, an unbatched ``predict`` records the seven stage
  spans in order, inside the call's interval;
- answers are identical with the profiler on and off;
- ``obs`` still imports without torch;
- ``pio train --profile-dir``'s Chrome trace holds the DASE stages.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.obs import device as pdevice
from predictionio_tpu_torch.obs import trace as ptrace
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import sessionrec
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.train import run_train

pytestmark = pytest.mark.obs

REPO = Path(__file__).resolve().parent.parent

STAGES = ["seqrec.prepare", "seqrec.stack", "seqrec.copy_in", "seqrec.forward",
          "seqrec.topk", "seqrec.fetch", "seqrec.decode"]
#: one bucket's stages: a batch of 3 queries runs buckets of 2 and 1
BUCKET = STAGES[1:]


@pytest.fixture(scope="module")
def served():
    """A tiny sessionrec model on the CPU and its algorithm."""
    cfg = seqrec.SeqRecConfig(vocab=41, max_len=16, d_model=32, n_heads=2, n_layers=2)
    items = [f"i{n}" for n in range(40)]
    histories = {f"u{u}": [items[(u * 7 + t) % 40] for t in range(3 + 2 * u)]
                 for u in range(8)}
    model = sessionrec.init_engine_model(cfg, items, histories, seed=3, device="cpu")
    return sessionrec.SeqRecAlgorithm(sessionrec.AlgorithmParams()), model


def _queries(n: int):
    return [(i, sessionrec.Query(user=f"u{i % 8}", num=5,
                                 black_list=("i3",) if i % 3 == 0 else ()))
            for i in range(n)]


def _answers(out):
    return [(i, [(s.item, s.score) for s in r.item_scores]) for i, r in out]


def _host_events(prof):
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda e: e[1])


def test_profiler_sees_the_stages_in_order_inside_the_caller(served):
    alg, model = served
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller.query_batch"):
            alg.batch_predict(model, _queries(4))
    events = _host_events(prof)
    (caller,) = [e for e in events if e[0] == "caller.query_batch"]
    stages = [e for e in events if e[0].startswith("seqrec.")]
    assert [name for name, _, _ in stages] == STAGES
    assert all(caller[1] <= s <= e <= caller[2] for _, s, e in stages)
    # stages follow one another without overlapping
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    flags = {e.name(): e.is_user_annotation()
             for e in prof.profiler.kineto_results.events() if e.name() in STAGES}
    assert set(flags) == set(STAGES) and all(flags.values())


def test_profiler_sees_one_set_of_stages_per_bucket(served):
    alg, model = served
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        alg.batch_predict(model, _queries(3))
    names = [name for name, _, _ in _host_events(prof) if name.startswith("seqrec.")]
    assert names == ["seqrec.prepare", *BUCKET, *BUCKET]


def test_off_path_is_the_shared_no_op_and_never_enters_record_function(served, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert ptrace.active_trace() is None
    assert ptrace.span("seqrec.prepare") is ptrace._NULL_SPAN
    alg, model = served
    assert len(alg.batch_predict(model, _queries(4))) == 4
    # a bound trace records its spans and still enters no annotation
    trace = ptrace.start_trace("query")
    with ptrace.use_trace(trace):
        alg.predict(model, sessionrec.Query(user="u1", num=3))
    assert [s[0] for s in trace.spans()] == STAGES


def test_bound_trace_records_the_stages_inside_the_call(served):
    alg, model = served
    trace = ptrace.start_trace("queries.json")
    with ptrace.use_trace(trace):
        t0 = time.perf_counter()
        result = alg.predict(model, sessionrec.Query(user="u5", num=4))
        t1 = time.perf_counter()
    assert len(result.item_scores) == 4
    spans = trace.spans()
    assert [s[0] for s in spans] == STAGES
    start, end = t0 - trace.start_perf, t1 - trace.start_perf
    assert all(start <= off and off + dur <= end for _, _, _, off, dur in spans)
    assert all(a[3] + a[4] <= b[3] for a, b in zip(spans, spans[1:]))


def test_bound_trace_under_a_profiler_feeds_both(served):
    alg, model = served
    trace = ptrace.start_trace("queries.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof, ptrace.use_trace(trace):
        alg.predict(model, sessionrec.Query(user="u2", num=4))
    assert [s[0] for s in trace.spans()] == STAGES
    assert [n for n, _, _ in _host_events(prof) if n.startswith("seqrec.")] == STAGES


@pytest.mark.parametrize("n", [1, 3, 8])
def test_answers_are_identical_with_the_profiler_on_and_off(served, n):
    alg, model = served
    queries = _queries(n) + [(n, sessionrec.Query(user="nobody", num=5))]
    off = _answers(alg.batch_predict(model, queries))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _answers(alg.batch_predict(model, queries))
    assert on == off
    assert all(len(items) == 5 for i, items in off if i < n)


def test_obs_imports_without_torch():
    code = (
        "import sys\n"
        "import predictionio_tpu_torch.obs\n"
        "from predictionio_tpu_torch.obs import trace\n"
        "assert trace.span('x') is trace._NULL_SPAN\n"
        "t = trace.start_trace('q')\n"
        "with trace.use_trace(t), trace.span('stage'):\n"
        "    pass\n"
        "assert [s[0] for s in t.spans()] == ['stage']\n"
        "print('torch' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_train_profile_dir_trace_shows_the_dase_stages(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path / "models"))
    storage = memory_storage()
    app_id = storage.get_meta_data_apps().insert(App(0, "SessApp"))
    events = storage.get_events()
    events.init(app_id)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    for u in range(4):
        for t in range(6):
            events.insert(Event(event="view", entity_type="user", entity_id=f"u{u}",
                                target_entity_type="item", target_entity_id=f"i{(u + t) % 8}",
                                event_time=t0 + timedelta(minutes=u * 100 + t)), app_id)
    variant = {"id": "s", "engineFactory":
               "predictionio_tpu_torch.templates.sessionrec.engine_factory",
               "datasource": {"params": {"app_name": "SessApp"}},
               "algorithms": [{"name": "seqrec", "params": dict(
                   d_model=16, n_heads=2, n_layers=1, max_len=8, epochs=1, batch_size=4,
                   seed=0)}]}
    profiler = pdevice.TrainProfiler(profile_dir=str(tmp_path / "trace"))
    outcome = run_train(variant=variant, ctx=EngineContext(storage=storage, device="cpu"),
                        profiler=profiler)
    assert outcome.status == "COMPLETED"
    doc = json.loads((tmp_path / "trace" / pdevice.TrainProfiler.TRACE_FILE).read_text())
    names = [e["name"] for e in doc["traceEvents"] if e.get("cat") == "user_annotation"]
    stages = [n for n in names if n in ("read", "prepare", "train", "persist")]
    # the engine's persist stage and the workflow's save are both "persist"
    assert list(dict.fromkeys(stages)) == ["read", "prepare", "train", "persist"]
    assert list(outcome.stage_seconds) == ["read", "prepare", "train", "persist"]
