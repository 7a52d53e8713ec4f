"""The parallel evaluation grid (``predictionio_tpu_torch/experiment/grid.py``)
on the card: a two-point sessionrec grid forked with ``device="cuda"``
from a parent that has not initialized CUDA, each child training and
predicting through the flash kernel, against the same grid run serially;
and the refusal to fork from a parent that has initialized CUDA.

The forked run happens in a fresh interpreter (this test process may
have initialized CUDA already). Needs an NVIDIA card; every test skips
without one. Imports no JAX:

    python -m pytest tests/test_torch_grid_cuda.py --noconftest
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
#: HitRate@10 over 24 held-out users a point: the forked and the serial
#: run train the same seeds on one card, and may differ only where a
#: near-tie of bf16 scores flips one user's hit
SCORE_TOL = 1 / 24

CHILD = r"""
import json, os, sys
from datetime import datetime, timedelta, timezone
import numpy as np
import torch
from predictionio_tpu_torch.controller import EngineParams, EngineParamsGenerator
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import sessionrec
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.evaluation import run_evaluation

log = sys.argv[1]
real = sessionrec.SeqRecAlgorithm.batch_predict

def spy(self, model, queries):
    before = flash_ops.LAUNCHES
    out = real(self, model, queries)
    with open(log, "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "launches": flash_ops.LAUNCHES - before,
                            "device": str(model.device)}) + "\n")
    return out

sessionrec.SeqRecAlgorithm.batch_predict = spy
rng = np.random.default_rng(0)
t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
storage = memory_storage()
app = storage.get_meta_data_apps().insert(App(0, "SessApp"))
storage.get_events().init(app)
events = []
for u in range(48):
    item = int(rng.integers(40))
    for t in range(40):
        item = (item + 1) % 40 if rng.random() < 0.6 else int(rng.integers(40))
        events.append(Event(event="view", entity_type="user", entity_id=f"u{u}",
                            target_entity_type="item", target_entity_id=f"i{item}",
                            event_time=t0 + timedelta(minutes=100 * u + t)))
storage.get_events().insert_batch(events, app)
grid = EngineParamsGenerator([EngineParams.of(
    data_source=sessionrec.DataSourceParams(app_name="SessApp", eval_k=2),
    algorithms=[("seqrec", sessionrec.AlgorithmParams(
        d_model=64, n_heads=2, n_layers=2, max_len=64, batch_size=8, epochs=2, lr=lr))])
    for lr in (1e-3, 3e-3)])
out = {"parent": os.getpid()}
for parallel in (2, 1):
    ctx = EngineContext(storage=storage, device="cuda")
    out[f"initialized_before_{parallel}"] = torch.cuda.is_initialized()
    o = run_evaluation(sessionrec.SessionRecEvaluation(output_path=None), grid, ctx=ctx,
                       parallel=parallel)
    row = storage.get_meta_data_evaluation_instances().get(o.instance_id)
    out[str(parallel)] = {"best": o.result.best_idx, "status": row.status,
                          "scores": [ms.score for _, ms in o.result.engine_params_scores],
                          "points": json.loads(row.evaluator_results_json).get("points")}
print(json.dumps(out))
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def test_forked_grid_on_the_card_equals_the_serial_one(cuda, tmp_path):
    log = tmp_path / "children.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", CHILD, str(log)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["initialized_before_2"] is False
    forked, serial = out["2"], out["1"]
    assert forked["status"] == serial["status"] == "EVALCOMPLETED"
    assert [q["status"] for q in forked["points"]] == ["COMPLETED", "COMPLETED"]
    assert forked["scores"] == pytest.approx(serial["scores"], abs=SCORE_TOL)
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    children = {r["pid"] for r in rows[:4]}
    # two folds a point: the forked points ran in two other processes,
    # the serial ones in the parent
    assert len(rows) == 8 and len(children) == 2 and out["parent"] not in children
    assert {r["pid"] for r in rows[4:]} == {out["parent"]}
    assert all(r["device"].startswith("cuda") and r["launches"] > 0 for r in rows)


def test_a_parent_with_cuda_initialized_refuses_to_fork(cuda):
    from predictionio_tpu_torch.experiment import grid
    from predictionio_tpu_torch.workflow.context import EngineContext

    torch.zeros(1, device=cuda)
    assert torch.cuda.is_initialized()
    ctx = EngineContext(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is already initialized"):
        grid.run_parallel_grid(None, None, [], ctx, 2)
