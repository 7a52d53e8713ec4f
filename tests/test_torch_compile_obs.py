"""The port's build sentinel (``predictionio_tpu_torch/obs/compile.py``)
and train profiler (``obs/device.py``) on the CPU: the counterpart of
tests/test_compile_obs.py.

- the recorder keeps the JAX recorder's counts, table, binning and
  ``stats_doc()`` for the same calls;
- a real build through ``ops/_build.build_all`` (a stand-in ``nvcc``)
  and ``native/`` (``g++``) is one compile each; after
  ``mark_warmup_complete`` it is one serving recompile, with a WARN and
  a ``kernel_build`` span on the ambient trace; a load of a built
  library is no compile;
- ``pio train --profile`` on the CPU writes a report whose keys equal
  the JAX package's, MFU null with a reason in both; with
  ``PIO_DEVICE_PEAK_FLOPS`` a numeric MFU; the sessionrec train's
  counted FLOPs equal ``chip_smoke.seqrec_train_flops`` exactly;
- the device memory collector reads nothing from ``torch.cuda`` while
  CUDA is not initialized, and renders the three gauges when it is.
"""

from __future__ import annotations

import json
import logging
import stat
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import chip_smoke
from predictionio_tpu.cli import pio as jpio
from predictionio_tpu.obs import compile as jcompile
from predictionio_tpu.obs import device as jdevice
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.utils.resilience import ManualClock as JaxManualClock
from predictionio_tpu_torch import native
from predictionio_tpu_torch.cli import pio
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.obs import compile as pcompile
from predictionio_tpu_torch.obs import device as pdevice
from predictionio_tpu_torch.obs.exporter import render_metrics
from predictionio_tpu_torch.obs.trace import Trace, use_trace
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.utils.resilience import ManualClock
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.train import run_train

pytestmark = [pytest.mark.obs, pytest.mark.profile]

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)


@pytest.fixture
def fresh_recorder(monkeypatch):
    """A fresh process-global build recorder (and no last train report)."""
    rec = pcompile.CompileRecorder()
    monkeypatch.setattr(pcompile, "_GLOBAL_RECORDER", rec)
    monkeypatch.setattr(pdevice, "_LAST_REPORT", None)
    return rec


# -- the recorder against JAX's ----------------------------------------------

CALL_SEQUENCES = {
    "counts": [("compile", "f", "(f32[4])", 0.5, None, None),
               ("compile", "f", "(f32[8])", 0.25, None, None),
               ("compile", "g", "(f32[4])", 1.0, None, None)],
    "warmup": [("compile", "f", "a", 0.1, None, None), ("warmup",),
               ("compile", "f", "b", 0.1, None, None),
               ("compile", "f", "b", 0.1, None, None)],
    "binning": [("compile", "f", "a", 2.0, 10.0, 12.0), ("compile", "f", "b", 2.0, 20.0, 22.0),
                ("advance", 5.0), ("compile", "h", "c", 0.5, None, None)],
    "reset": [("compile", "f", "a", 0.1, None, None), ("warmup",), ("reset",),
              ("compile", "g", "x", 0.3, None, None)],
}


def _drive(rec, clock, calls) -> list:
    returned = []
    for call in calls:
        if call[0] == "compile":
            _, fn, sig, seconds, start, end = call
            returned.append(rec.record_compile(fn, sig, seconds, start=start, end=end))
        elif call[0] == "warmup":
            rec.mark_warmup_complete()
        elif call[0] == "reset":
            rec.reset()
        else:
            clock.advance(call[1])
    return returned


@pytest.mark.parametrize("case", sorted(CALL_SEQUENCES))
def test_recorder_matches_jax_on_the_same_calls(case):
    views = []
    for rec_cls, clock_cls in ((pcompile.CompileRecorder, ManualClock),
                               (jcompile.CompileRecorder, JaxManualClock)):
        clock = clock_cls(100.0)
        rec = rec_cls(clock=clock)
        returned = _drive(rec, clock, CALL_SEQUENCES[case])
        views.append((returned, rec.totals(), rec.compiles_by_fn(), rec.seconds_by_fn(),
                      rec.recompile_table(), rec.events(), rec.stats_doc(),
                      rec.compile_seconds_between(10.0, 15.0),
                      rec.compile_seconds_between(15.0, 30.0)))
    assert views[0] == views[1]


def test_collector_families_always_present_and_per_function_on_first_build():
    rec = pcompile.CompileRecorder()
    text = render_metrics(pcompile.compile_metrics_collector(rec)())
    assert "pio_jit_compile_seconds_total 0" in text
    assert "pio_serving_recompile_total 0" in text
    assert "pio_jit_compiles_total" not in text
    rec.record_compile("flash_attention", "csrc/flash_attention.cu", 8.5)
    text = render_metrics(pcompile.compile_metrics_collector(rec)())
    assert 'pio_jit_compiles_total{fn="flash_attention"} 1' in text
    jrec = jcompile.CompileRecorder()
    jrec.record_compile("flash_attention", "csrc/flash_attention.cu", 8.5)
    jtext = render_metrics(jcompile.compile_metrics_collector(jrec)())
    # the same samples under the same names (the help text names builds)
    assert ([line for line in text.splitlines() if not line.startswith("# HELP")]
            == [line for line in jtext.splitlines() if not line.startswith("# HELP")])


# -- real builds --------------------------------------------------------------

@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``ops/_build`` over a csrc/ with one source, built by a stand-in
    ``nvcc`` that writes its output file."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a stand-in kernel source\n")
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                      'echo "ptxas info: fake" && : > "$2"\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    return csrc


def test_a_kernel_build_is_one_compile_and_a_load_is_none(fake_nvcc, fresh_recorder):
    logs = _build.build_all(["fake"])
    assert "ptxas info: fake" in logs["fake"]
    assert _build.library_path("fake").exists()
    doc = fresh_recorder.stats_doc()
    assert doc["compiles"] == 1 and doc["byFunction"] == {"fake": 1}
    assert doc["servingRecompiles"] == 0 and doc["compileSeconds"] >= 0
    (row,) = fresh_recorder.recompile_table()
    assert row["signature"].endswith("fake.cu")
    # built before: a load, not a compile
    assert _build.build_all(["fake"]) == {}
    assert fresh_recorder.totals()[0] == 1


def test_a_build_after_warmup_is_a_serving_recompile(fake_nvcc, fresh_recorder, caplog):
    pcompile.mark_warmup_complete()
    trace = Trace("queries.json")
    with caplog.at_level(logging.WARNING, logger=pcompile.__name__), use_trace(trace):
        _build.build_all(["fake"])
    assert fresh_recorder.totals()[2] == 1
    assert pcompile.stats_doc()["servingRecompiles"] == 1
    assert any("AFTER warmup" in r.getMessage() and "fake" in r.getMessage()
               for r in caplog.records)
    assert [s[0] for s in trace.spans()] == ["kernel_build"]
    text = render_metrics(pcompile.compile_metrics_collector()())
    assert "pio_serving_recompile_total 1" in text


def test_a_native_build_is_one_compile_and_a_load_is_none(tmp_path, monkeypatch,
                                                         fresh_recorder):
    src = tmp_path / "native"
    src.mkdir()
    (src / "tiny.cc").write_text('extern "C" int pio_tiny(void) { return 7; }\n')
    monkeypatch.setattr(native, "_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    lib = native._load("tiny", lambda lib: None)
    if lib is None:
        pytest.skip("no g++ here")
    assert lib.pio_tiny() == 7
    assert fresh_recorder.compiles_by_fn() == {"tiny": 1}
    # another process (a fresh cache) finds the library built: a load
    monkeypatch.setattr(native, "_libs", {})
    assert native._load("tiny", lambda lib: None).pio_tiny() == 7
    assert fresh_recorder.totals()[0] == 1


# -- pio train --profile ------------------------------------------------------

def _rate_events(n_users=20, n_items=12, seed=11) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
             "targetEntityType": "item", "targetEntityId": f"i{i}",
             "properties": {"rating": 4.0},
             "eventTime": (T0 + timedelta(seconds=u * 100 + i)).strftime(
                 "%Y-%m-%dT%H:%M:%S.000Z")}
            for u in range(n_users) for i in range(n_items) if rng.random() < 0.5]


def _key_tree(doc):
    """The nested key structure of a report: dict keys all the way down,
    except under ``stages`` and ``compile.table`` (names and rows)."""
    if isinstance(doc, dict):
        return {k: (sorted(v) if k == "stages" else
                    "rows" if k == "table" else _key_tree(v)) for k, v in doc.items()}
    return type(doc).__name__ if doc is None else "value"


def _profiled_cli_train(main, tmp_path, monkeypatch, name, factory, *extra):
    """`pio app new` → `import` → `train --profile` through one package's
    `pio` main in a fresh directory and store; the report it wrote."""
    base = tmp_path / name
    base.mkdir()
    monkeypatch.chdir(base)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base / "store"))
    JaxStorage.reset_default()
    events = base / "events.jsonl"
    events.write_text("".join(json.dumps(e) + "\n" for e in _rate_events()))
    # 3 iterations, not tests/test_compile_obs.py's 2: the JAX package
    # counts a program's compile once a process, so that file's profiled
    # train, run after this one in one pytest process, would count none
    (base / "engine.json").write_text(json.dumps({
        "id": "prof", "engineFactory": factory,
        "datasource": {"params": {"appName": "ProfApp"}},
        "algorithms": [{"name": "als", "params": {"rank": 3, "numIterations": 3,
                                                  "lambda": 0.05, "seed": 2}}]}))
    assert main(["app", "new", "ProfApp", "--id", "1"]) == 0
    assert main(["import", "--appid", "1", "--input", str(events)]) == 0
    rc = main(["train", "--profile", "--profile-dir", str(base / "trace"), *extra])
    assert rc == 0
    return json.loads((base / "TRAIN_REPORT.json").read_text())


def test_pio_train_profile_report_keys_equal_jax(tmp_path, monkeypatch, capsys,
                                                 fresh_recorder):
    monkeypatch.delenv("PIO_DEVICE_PEAK_FLOPS", raising=False)
    # a cold JAX recorder too: one left past warmup by an earlier test in
    # this process would add an xla_compile span to the JAX run's stages
    monkeypatch.setattr(jcompile, "_GLOBAL_RECORDER", jcompile.CompileRecorder())
    monkeypatch.setattr(jdevice, "_LAST_REPORT", None)
    try:
        want = _profiled_cli_train(
            jpio.main, tmp_path, monkeypatch, "jax",
            "predictionio_tpu.templates.recommendation.engine_factory")
        got = _profiled_cli_train(
            pio.main, tmp_path, monkeypatch, "port",
            "predictionio_tpu_torch.templates.recommendation.engine_factory",
            "--device", "cpu")
    finally:
        JaxStorage.reset_default()
    out = capsys.readouterr().out
    assert out.count("[INFO] Train profile: wall ") == 2
    assert out.count("[INFO] Stage times: read ") == 2
    assert "torch.profiler trace in" in out
    assert _key_tree(got) == _key_tree(want)
    for report in (got, want):
        assert report["schema"] == "pio.train_report.v1"
        assert report["status"] == "COMPLETED"
        assert set(report["stages"]) >= {"read", "prepare", "train", "persist"}
        assert report["mfu"] is None and report["mfuReason"]
        assert report["hbm"] == {"peakBytes": None, "perStage": None}
    assert got["deviceKind"] == "cpu"
    assert "no peak-FLOPs table entry for device kind 'cpu'" in got["mfuReason"]
    # the ALS products were counted in the train stage
    assert got["flops"]["executed"] > 0 and got["flops"]["peakSource"] is None
    assert (tmp_path / "port" / "trace" / pdevice.TrainProfiler.TRACE_FILE).is_file()


def _sessions(storage, n_users=6, length=9, cycle=10):
    app_id = storage.get_meta_data_apps().insert(App(0, "SessApp"))
    events = storage.get_events()
    events.init(app_id)
    for u in range(n_users):
        for t in range(length):
            events.insert(Event(event="view", entity_type="user", entity_id=f"u{u}",
                                target_entity_type="item",
                                target_entity_id=f"i{(u + t) % cycle}",
                                event_time=T0 + timedelta(minutes=u * 100 + t)), app_id)
    return storage


@pytest.mark.parametrize("remat", [False, True])
def test_sessionrec_flops_equal_the_analytic_count(remat, tmp_path, monkeypatch,
                                                   fresh_recorder):
    monkeypatch.setenv("PIO_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("PIO_DEVICE_PEAK_FLOPS", "1e12")
    params = dict(d_model=16, n_heads=2, n_layers=2, max_len=8, epochs=2, batch_size=4,
                  lr=1e-3, seed=0, remat=remat)
    storage = _sessions(memory_storage())
    variant = {"id": "s", "engineFactory":
               "predictionio_tpu_torch.templates.sessionrec.engine_factory",
               "datasource": {"params": {"app_name": "SessApp"}},
               "algorithms": [{"name": "seqrec", "params": params}]}
    profiler = pdevice.TrainProfiler()
    outcome = run_train(variant=variant, ctx=EngineContext(storage=storage, device="cpu"),
                        profiler=profiler)
    report = outcome.report
    cfg = outcome.models[0].cfg
    assert cfg.vocab == 11 and cfg.remat is remat
    want = chip_smoke.seqrec_train_flops(cfg, n_sequences=6, batch_size=4, epochs=2)
    assert report["flops"]["executed"] == want
    assert report["flops"]["peakSource"] == "env"
    assert 0 < report["mfu"] <= 1 and report["mfuReason"] == "ok"
    assert list(outcome.stage_seconds) == ["read", "prepare", "train", "persist"]
    text = render_metrics(pdevice.train_report_collector()())
    assert "pio_train_mfu " in text and "pio_train_compile_seconds 0" in text
    # finished: a second finish returns the same report, and nothing counts
    assert profiler.finish(None) is report
    with pdevice.count_flops():
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert pdevice._LAST_REPORT["flops"]["executed"] == want


def test_count_flops_adds_flash_launches_through_the_hook(fresh_recorder):
    """A launch reports 4·D FLOPs per real causal pair (the CPU path
    launches nothing, so the hook is called directly)."""
    profiler = pdevice.TrainProfiler()
    profiler.begin(None, device="cpu")
    try:
        with pdevice.count_flops():
            mask = torch.tensor([[1.0, 1.0, 1.0, 0.0], [1.0, 0.0, 0.0, 0.0]])
            q = torch.zeros(2, 3, 4, 16)
            flash_ops.flop_hook.get()(flash_ops.launch_flops(q, mask, causal=True))
        assert flash_ops.flop_hook.get() is None
    finally:
        report = profiler.finish(None)
    # real keys at positions 0-2 (row 0) and 0 (row 1) meet 4+3+2 and 4 queries
    assert report["flops"]["executed"] == 4 * 16 * 3 * (9 + 4)
    assert flash_ops.launch_flops(q, mask, causal=False) == 4 * 16 * 3 * 4 * 4


def test_mfu_never_reads_above_one():
    mfu, reason = pdevice.TrainProfiler._mfu(2e12, 1e12, "table", 1.0)
    assert mfu is None and "exceed the peak" in reason
    assert pdevice.TrainProfiler._mfu(5e11, 1e12, "table", 1.0) == (0.5, "ok")
    assert pdevice.TrainProfiler._mfu(None, 1e12, "table", 1.0)[0] is None
    assert pdevice.TrainProfiler._mfu(1.0, 1e12, "table", 0.0)[0] is None


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                                  "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB", "cpu",
                                  "TPU v4", "TPU v5 lite", "TPU v6e"])
def test_peak_flops_resolution(kind, monkeypatch):
    monkeypatch.delenv("PIO_DEVICE_PEAK_FLOPS", raising=False)
    value, source = pdevice.resolve_peak_flops(kind)
    if kind == "NVIDIA H100 80GB HBM3":
        assert (value, source) == (989e12, "table")
    elif "H100" in kind or kind in ("NVIDIA A100-SXM4-80GB", "cpu"):
        # no guess for another part
        assert value is None and "PIO_DEVICE_PEAK_FLOPS" in source
    else:
        # the JAX package's rows, resolved as it resolves them
        assert (value, source) == jdevice.resolve_peak_flops(kind)
    monkeypatch.setenv("PIO_DEVICE_PEAK_FLOPS", "not-a-number")
    assert pdevice.resolve_peak_flops(kind)[0] == value
    monkeypatch.setenv("PIO_DEVICE_PEAK_FLOPS", "2.5e13")
    assert pdevice.resolve_peak_flops(kind) == (2.5e13, "env")


# -- device memory ------------------------------------------------------------

class _Untouchable:
    def __call__(self, *args, **kwargs):
        raise AssertionError("torch.cuda was read while CUDA is not initialized")


@pytest.mark.parametrize("name", ["memory_stats", "get_device_properties",
                                  "get_device_name", "device_count", "is_available",
                                  "mem_get_info", "max_memory_allocated"])
def test_no_cuda_read_while_cuda_is_not_initialized(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, name, _Untouchable())
    assert pdevice.device_memory_snapshot() == {}
    assert pdevice.device_memory_collector()() == []
    assert pdevice._device_kind("cuda") == "cuda (not initialized)"


def test_memory_gauges_once_cuda_is_initialized(monkeypatch):
    stats = {"allocated_bytes.all.current": 3 << 20, "allocated_bytes.all.peak": 7 << 20}

    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda idx: dict(stats))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda idx: Props())
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda idx=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "is_available", _Untouchable())
    monkeypatch.setattr(torch.cuda, "mem_get_info", _Untouchable())
    text = render_metrics(pdevice.device_memory_collector()())
    labels = '{device="cuda:0",kind="NVIDIA H100 80GB HBM3"}'
    assert f"pio_device_bytes_in_use{labels} {3 << 20}" in text
    assert f"pio_device_peak_bytes_in_use{labels} {7 << 20}" in text
    assert f"pio_device_bytes_limit{labels} {80 << 30}" in text
    assert pdevice._device_kind("cuda:0") == "NVIDIA H100 80GB HBM3"
    # the profiler samples the high-water as each stage closes
    profiler = pdevice.TrainProfiler()
    trace = Trace("train")
    profiler.begin(trace, device="cuda")
    try:
        trace.add_span("train", 0.0, 0.5)
    finally:
        report = profiler.finish(trace, "i", "COMPLETED")
    assert report["hbm"] == {"peakBytes": float(7 << 20), "perStage": {
        "train": {"peak_bytes_in_use": float(7 << 20), "bytes_in_use": float(3 << 20)}}}
    assert report["deviceKind"] == "NVIDIA H100 80GB HBM3"
    assert report["flops"]["executed"] is None and report["mfu"] is None
