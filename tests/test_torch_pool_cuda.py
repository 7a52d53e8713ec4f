"""The port's prefork serving pool on the card: `pio deploy --workers 2
--batching` over a small trained sessionrec instance answers, every worker
(each its own CUDA context, started from the ``spawn`` context) launches
the flash kernel, the launches add up to n_layers x popcount of each
worker's dispatched batch sizes, and only the deploy process built
kernels (before the siblings started): no sibling built one.

Needs an NVIDIA card; every test skips without one. Imports no JAX:

    python -m pytest tests/test_torch_pool_cuda.py --noconftest
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
LAYERS = 2
N_USERS, LENGTH, N_ITEMS = 24, 40, 60


def _pio(env, cwd, *args, timeout=300) -> str:
    p = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.cli.pio", *args],
                       cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _peers(tmp: Path) -> dict[str, dict]:
    """The pool's workers, read from its spool: worker id -> entry."""
    (spool,) = glob.glob(str(tmp / "pio-deploy-workers-*"))
    out = {}
    for path in glob.glob(os.path.join(spool, "*.json")):
        with open(path) as f:
            doc = json.load(f)
        out[doc["worker"]] = doc
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.device_count():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def test_a_two_worker_pool_answers_and_every_worker_launches(cuda, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_") and k != "PIO_MODEL_DIR"}
    env.update(PIO_FS_BASEDIR=str(tmp_path / "store"), PYTHONPATH=str(REPO),
               TMPDIR=str(tmp_path))
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    events = tmp_path / "events.jsonl"
    events.write_text("".join(json.dumps({
        "event": "view", "entityType": "user", "entityId": f"u{u}",
        "targetEntityType": "item", "targetEntityId": f"i{(7 * u + t) % N_ITEMS}",
        "eventTime": (t0 + timedelta(seconds=LENGTH * u + t)).strftime(
            "%Y-%m-%dT%H:%M:%S.000Z")}) + "\n" for u in range(N_USERS) for t in range(LENGTH)))
    app_id = re.search(r"ID: (\d+)", _pio(env, tmp_path, "app", "new", "S")).group(1)
    _pio(env, tmp_path, "import", "--appid", app_id, "--input", str(events))
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "s", "engineFactory": "predictionio_tpu_torch.templates.sessionrec.engine_factory",
        "datasource": {"params": {"app_name": "S"}},
        "algorithms": [{"name": "seqrec", "params": {
            "d_model": 32, "n_heads": 2, "n_layers": LAYERS, "max_len": 64, "epochs": 1,
            "batch_size": 8}}]}))
    _pio(env, tmp_path, "train", "--device", cuda)

    log = open(tmp_path / "deploy.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.pio", "deploy", "--ip", "127.0.0.1",
         "--port", "0", "--device", cuda, "--workers", "2", "--batching"],
        cwd=tmp_path, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 300
        while not (found := re.search(r"listening on 127\.0\.0\.1:(\d+)",
                                      (tmp_path / "deploy.log").read_text())) \
                or len(_peers(tmp_path)) < 2:
            assert proc.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "deploy.log").read_text()
            time.sleep(0.2)
        port = int(found.group(1))
        # 8 clients at once over fresh connections: the kernel spreads
        # them over both workers
        bodies = [{"user": f"u{u}", "num": 5} for u in range(N_USERS)] * 2
        answers: list = [None] * len(bodies)

        def client(k: int) -> None:
            for j in range(k, len(bodies), 8):
                answers[j] = _post(port, bodies[j])

        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(len(a["itemScores"]) == 5 for a in answers)
        launches = 0
        for worker, entry in _peers(tmp_path).items():
            status = _get(entry["port"], "/")
            stats = _get(entry["port"], "/stats.json")
            hist = {int(n): c for n, c in stats["serving"]["batchSizeHistogram"].items()}
            own = status["kernelLaunches"]["flash_attention"]
            assert status["device"].startswith("cuda")
            assert own > 0, f"worker {worker} launched nothing"
            assert own == LAYERS * sum(c * bin(n).count("1") for n, c in hist.items())
            if entry["pid"] != proc.pid:
                assert stats["compile"]["compiles"] == 0, f"sibling {worker} built a kernel"
            launches += own
        pool = _get(port, "/stats.json")["workers"]
        assert pool["count"] == 2 and pool["requestCount"] == len(bodies)
        assert launches > 0
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        log.close()
