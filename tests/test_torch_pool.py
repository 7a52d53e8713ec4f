"""`pio deploy --workers 2 --device cpu --supervise --shm-cache` of the
port as a subprocess over a small ALS instance trained by `pio train`:

- the sibling comes from the ``spawn`` context (its command line is
  multiprocessing's spawn entry), and both workers answer on the shared
  port, each answer equal to the instance deployed in this process;
- ``/metrics`` is the folded view: ``pio_serving_workers`` 2, and each
  serving counter the sum of the workers' own expositions;
- the sibling SIGKILLed after the deploy process itself has run torch CPU
  ops is respawned (from the spawn context again) and answers; the shared
  cache segment survives the kill and the deploy process removes it, and
  the spool directory, when it stops (a second SIGTERM during that
  teardown included).
"""

from __future__ import annotations

import glob
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.workflow.deploy import ServerConfig, load_deployed_engine

REPO = Path(__file__).resolve().parent.parent
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)


def _events(n_users=20, n_items=40, n=600, seed=0):
    rng = np.random.default_rng(seed)
    for j in range(n):
        doc = {"event": "rate" if j % 5 else "buy", "entityType": "user",
               "entityId": f"u{rng.integers(n_users)}", "targetEntityType": "item",
               "targetEntityId": f"i{rng.integers(n_items)}",
               "eventTime": (T0 + timedelta(seconds=j)).strftime("%Y-%m-%dT%H:%M:%S.000Z")}
        if j % 5:
            doc["properties"] = {"rating": float(rng.integers(1, 6))}
        yield doc


def _pio(env, cwd, *args) -> str:
    p = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.cli.pio", *args],
                       cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _workers(tmp: Path) -> dict[int, dict]:
    """Live workers in the pool's spool: pid -> entry."""
    out = {}
    for path in glob.glob(str(tmp / "pio-deploy-workers-*" / "*.json")):
        try:
            with open(path) as f:
                doc = json.load(f)
            os.kill(doc["pid"], 0)
        except (OSError, ValueError, KeyError):
            continue
        out[doc["pid"]] = doc
    return out


def _counters(text: str) -> dict[str, float]:
    return {line.split()[0]: float(line.split()[1]) for line in text.splitlines()
            if line.startswith("pio_serving_") and "{" not in line}


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not (got := pred()):
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)
    return got


def test_a_supervised_cpu_pool_spawns_folds_and_respawns(tmp_path):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_") and k != "PIO_MODEL_DIR"}
    env.update(PIO_FS_BASEDIR=str(tmp_path / "store"), PYTHONPATH=str(REPO), TMPDIR=str(tmp))
    app_id = re.search(r"ID: (\d+)", _pio(env, tmp_path, "app", "new", "MyApp")).group(1)
    (tmp_path / "events.jsonl").write_text("".join(json.dumps(e) + "\n" for e in _events()))
    _pio(env, tmp_path, "import", "--appid", app_id, "--input", str(tmp_path / "events.jsonl"))
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "rec", "engineFactory":
            "predictionio_tpu_torch.templates.recommendation.engine_factory",
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 4,
                                                  "lambda": 0.05, "seed": 1}}]}))
    iid = re.search(r"engine instance (\w+) \(COMPLETED\)",
                    _pio(env, tmp_path, "train", "--device", "cpu")).group(1)
    log_path = tmp_path / "deploy.log"
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.pio", "deploy", "--ip", "127.0.0.1",
         "--port", "0", "--device", "cpu", "--workers", "2", "--supervise", "--shm-cache",
         "--batching"], cwd=tmp_path, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        found = _wait(lambda: re.search(r"listening on 127\.0\.0\.1:(\d+) \(2 worker\(s\), "
                                        r"supervised\)", log_path.read_text())
                      if proc.poll() is None else pytest.fail(log_path.read_text()),
                      120, "the pool to listen")
        port = int(found.group(1))
        workers = _wait(lambda: w if len(w := _workers(tmp)) == 2 else None, 120,
                        "both workers in the spool")
        (sibling,) = [pid for pid in workers if pid != proc.pid]
        with open(f"/proc/{sibling}/cmdline") as f:
            assert "spawn_main" in f.read()
        deployed = load_deployed_engine(Storage({"PIO_FS_BASEDIR": env["PIO_FS_BASEDIR"]}),
                                        ServerConfig(engine_instance_id=iid, device="cpu"))
        queries = [{"user": f"u{u}", "num": 4} for u in range(16)]
        for q in queries:
            want = deployed.query(prec.Query(user=q["user"], num=4))
            got = _post(port, q)
            assert [(s["item"], s["score"]) for s in got["itemScores"]] == \
                [(s.item, s.score) for s in want.item_scores]
        own = {pid: json.loads(_get(e["port"], "/stats.json"))["requestCount"]
               for pid, e in workers.items()}
        assert sum(own.values()) == len(queries) and min(own.values()) > 0
        folded = _counters(_get(port, "/metrics").decode())
        per = [_counters(_get(e["port"], "/metrics").decode()) for e in workers.values()]
        assert folded["pio_serving_workers"] == 2
        for name in ("pio_serving_cache_misses_total", "pio_serving_batched_queries_total"):
            assert folded[name] == sum(p[name] for p in per) == len(queries)
        # the deploy process has run torch CPU ops (it answered); a respawn
        # from it still comes up and answers
        segment = f"/dev/shm/pio-shm-{proc.pid}"
        os.kill(sibling, signal.SIGKILL)
        fresh = _wait(lambda: [e for pid, e in _workers(tmp).items()
                               if pid not in (proc.pid, sibling)], 120, "the respawn")[0]
        with open(f"/proc/{fresh['pid']}/cmdline") as f:
            assert "spawn_main" in f.read()
        assert os.path.exists(segment)

        def answered() -> bool:
            _post(port, {"user": "u1", "num": 3})
            return json.loads(_get(fresh["port"], "/stats.json"))["requestCount"] > 0

        _wait(answered, 60, "the respawned worker to answer")
    finally:
        proc.terminate()
        time.sleep(0.3)
        proc.terminate()        # a second SIGTERM, during the teardown
        proc.wait(timeout=60)
        log.close()
    assert not glob.glob(str(tmp / "pio-deploy-workers-*"))
    assert not os.path.exists(f"/dev/shm/pio-shm-{proc.pid}")


class _Captured(Exception):
    pass


POOL_FIELDS = ("workers", "cache_enabled", "shm_cache", "shm_slots", "shm_slot_bytes",
               "shm_segment", "reuse_port", "worker_spool_dir", "worker_index",
               "worker_peer_timeout_s", "admin_sync_interval_s")


@pytest.mark.parametrize("flags,env", [
    ([], {}),
    (["--shm-cache", "--shm-slots", "16", "--shm-slot-bytes", "2048", "--workers", "1"], {}),
    (["--no-shm-cache", "--cache"], {"PIO_SERVING_SHM": "1", "PIO_SERVING_SHM_SLOTS": "9"}),
    ([], {"PIO_SERVING_WORKERS": "1", "PIO_SERVING_SHM": "yes",
          "PIO_SERVING_WORKER_PEER_TIMEOUT_S": "0.5",
          "PIO_SERVING_ADMIN_SYNC_INTERVAL_S": "soon"}),
], ids=["defaults", "flags", "flags_over_env", "env"])
def test_deploy_pool_flags_equal_jax(tmp_path, monkeypatch, flags, env):
    """`pio deploy`'s pool flags and their PIO_SERVING_* defaults build the
    ServerConfig the JAX package's `pio deploy` builds (one worker: both
    reach create_engine_server in this process); --model-mmap sets
    PIO_CHECKPOINT_MMAP for the loads."""
    import predictionio_tpu.api.engine_server as jserver_mod
    from predictionio_tpu.cli import pio as jpio
    from predictionio_tpu.storage.registry import Storage as JaxStorage

    import predictionio_tpu_torch.api.engine_server as pserver_mod
    from predictionio_tpu_torch.cli import pio

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.delenv("PIO_CHECKPOINT_MMAP", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (tmp_path / "engine.json").write_text(json.dumps({"id": "e", "engineFactory": "x.f"}))
    configs = {}

    def capture(name):
        def create(storage=None, config=None, **kw):
            configs[name] = config
            raise _Captured()
        return create

    monkeypatch.setattr(pserver_mod, "create_engine_server", capture("port"))
    monkeypatch.setattr(jserver_mod, "create_engine_server", capture("jax"))
    args = ["deploy", "--ip", "127.0.0.1", "--port", "0", "--model-mmap", *flags]
    for name, main in (("port", pio.main), ("jax", jpio.main)):
        JaxStorage.reset_default()
        with pytest.raises(_Captured):
            main(args + (["--device", "cpu"] if name == "port" else []))
        assert os.environ.get("PIO_CHECKPOINT_MMAP") == "r"
    JaxStorage.reset_default()
    assert {f: getattr(configs["port"], f) for f in POOL_FIELDS} == \
        {f: getattr(configs["jax"], f) for f in POOL_FIELDS}


def test_resolve_concrete_port_equals_jax():
    from predictionio_tpu.cli.pio import resolve_concrete_port as jresolve

    from predictionio_tpu_torch.cli.pio import resolve_concrete_port

    assert resolve_concrete_port("127.0.0.1", 8123) == jresolve("127.0.0.1", 8123) == 8123
    port = resolve_concrete_port("127.0.0.1", 0)
    assert 0 < port < 65536


def test_a_worker_without_its_device_exits_non_zero(tmp_path):
    """A sibling whose config names the card, started where there is
    none (this CPU host), fails at start with a non-zero exit: it never
    serves on another device than its config's."""
    import multiprocessing

    import torch

    from predictionio_tpu_torch.cli import pio

    if torch.cuda.device_count():
        pytest.skip("a card is present")
    ctx = multiprocessing.get_context(pio.POOL_START_METHOD)
    config = ServerConfig(ip="127.0.0.1", port=0, device="cuda", workers=2, worker_index=1,
                          model_dir=str(tmp_path / "no-model"))
    child = ctx.Process(target=pio._deploy_worker, args=(config,))
    child.start()
    child.join(120)
    assert child.exitcode not in (None, 0)
