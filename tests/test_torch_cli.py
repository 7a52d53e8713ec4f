"""The port's `pio` (``predictionio_tpu_torch/cli/pio.py``) on the CPU: the
quickstart lifecycle `app new` → `import` → `train` → `deploy --device cpu`
→ `/queries.json` as separate processes over one sqlite + localfs store
(in the manner of tests/test_cli_workflow.py), and the administrative
commands' messages and exit codes against the JAX package's `pio` on the
same arguments.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.cli import pio as jpio
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu_torch.cli import pio
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.workflow.deploy import ServerConfig, load_deployed_engine

REPO = Path(__file__).resolve().parent.parent
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)


def _events(n_users=20, n_items=40, n=600, seed=0) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        doc = {"event": "rate" if j % 5 else "buy", "entityType": "user",
               "entityId": f"u{rng.integers(n_users)}", "targetEntityType": "item",
               "targetEntityId": f"i{rng.integers(n_items)}",
               "eventTime": (T0 + timedelta(seconds=j)).strftime("%Y-%m-%dT%H:%M:%S.000Z")}
        if j % 5:
            doc["properties"] = {"rating": float(rng.integers(1, 6))}
        out.append(doc)
    return out


def _run(env, cwd, *args, timeout=120) -> str:
    p = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.cli.pio", *args],
                       cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_app_new_import_train_deploy_query(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_") and k != "PIO_MODEL_DIR"}
    env.update(PIO_FS_BASEDIR=str(tmp_path / "store"),
               PYTHONPATH=os.pathsep.join([str(REPO)] + [p for p in
                                                          [env.get("PYTHONPATH")] if p]))
    out = _run(env, tmp_path, "app", "new", "MyApp")
    app_id = re.search(r"ID: (\d+)", out).group(1)
    assert re.search(r"Access Key: \S{64}", out)
    events = tmp_path / "events.jsonl"
    events.write_text("".join(json.dumps(e) + "\n" for e in _events()))
    assert "Imported 600 events" in _run(env, tmp_path, "import", "--appid", app_id,
                                          "--input", str(events))
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "rec", "engineFactory":
            "predictionio_tpu_torch.templates.recommendation.engine_factory",
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 4,
                                                  "lambda": 0.05, "seed": 1}}]}))
    out = _run(env, tmp_path, "train", "--device", "cpu")
    iid = re.search(r"engine instance (\w+) \(COMPLETED\)", out).group(1)
    assert re.search(r"Stage times: read \S+ \| prepare \S+ \| train \S+ \| persist", out)

    log = open(tmp_path / "deploy.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.pio", "deploy", "--ip",
         "127.0.0.1", "--port", "0", "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not (found := re.search(r"Engine instance (\w+) listening on 127\.0\.0\.1:(\d+)",
                                      (tmp_path / "deploy.log").read_text())):
            assert proc.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "deploy.log").read_text()
            time.sleep(0.1)
        assert found.group(1) == iid
        port = int(found.group(2))
        queries = [{"user": f"u{u}", "num": 5} for u in range(6)] + [
            {"user": "u1", "num": 3, "blackList": ["i1", "i2"]}, {"user": "nobody"}]
        answers = [_post(port, q) for q in queries]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
            status = json.loads(r.read())
        assert status["engineInstanceId"] == iid and status["requestCount"] == len(queries)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    # the same instance, deployed in this process from the same store
    deployed = load_deployed_engine(Storage({"PIO_FS_BASEDIR": env["PIO_FS_BASEDIR"]}),
                                    ServerConfig(engine_instance_id=iid, device="cpu"))
    for q, doc in zip(queries, answers):
        want = deployed.query(prec.Query(user=q["user"], num=q.get("num", 10),
                                         black_list=tuple(q.get("blackList", ())) or None))
        assert [(s["item"], s["score"]) for s in doc["itemScores"]] == \
            [(s.item, s.score) for s in want.item_scores]
    assert answers[0]["itemScores"] and answers[-1] == {"itemScores": []}


@pytest.fixture
def both(tmp_path, monkeypatch):
    """Run one argument list through the port's and the JAX package's
    `pio` main, each over its own fresh sqlite store; returns (rc, out)
    pairs with access keys masked."""
    monkeypatch.chdir(tmp_path)

    def run(capsys, *args):
        results = []
        for name, main in (("port", pio.main), ("jax", jpio.main)):
            monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / name))
            JaxStorage.reset_default()
            rc = main(list(args))
            out = re.sub(r"[A-Za-z0-9_-]{64}", "<key>", capsys.readouterr().out)
            results.append((rc, out))
        JaxStorage.reset_default()
        return results

    yield run


@pytest.mark.parametrize("steps", [
    [("app", "new", "A", "--description", "d"), ("app", "new", "A"), ("app", "list"),
     ("app", "show", "A"), ("app", "show", "B")],
    [("app", "new", "A", "--access-key", "k1"), ("app", "new", "B", "--access-key", "k1"),
     ("accesskey", "new", "A", "--access-key", "k2", "--event", "rate"),
     ("accesskey", "new", "C"), ("accesskey", "list", "A"), ("app", "delete", "A"),
     ("app", "delete", "A"), ("app", "list")],
    [("app", "new", "A"), ("import", "--appid", "9", "--input", "x.jsonl"),
     ("import", "--appid", "1", "--input", "missing.jsonl"),
     ("export", "--appid", "1", "--output", "out.jsonl", "--channel", "web"),
     ("export", "--appid", "1", "--output", "out.jsonl")],
    [("train", "--engine-json", "nope.json"), ("version",)],
], ids=["apps", "access_keys", "import_export_errors", "train_and_version"])
def test_messages_and_exit_codes_equal_jax(both, capsys, steps):
    for args in steps:
        port, jax = both(capsys, *args)
        if args[0] == "version":
            assert port[0] == jax[0] == 0 and port[1].strip()
            continue
        assert port == jax, args


def test_import_bad_line_and_status(both, capsys, tmp_path):
    (tmp_path / "bad.jsonl").write_text('{"event": "v", "entityType": "user", '
                                        '"entityId": "u"}\nnot json\n')
    both(capsys, "app", "new", "A")
    port, jax = both(capsys, "import", "--appid", "1", "--input", "bad.jsonl")
    assert port == jax and port[0] == 1 and "line 2" in port[1]
    port, _ = both(capsys, "status")
    assert port[0] == 0 and "all repositories verified" in port[1]


class _Captured(Exception):
    pass


DEPLOY_FIELDS = ("retrieval", "ann_nlist", "ann_nprobe", "ann_rescore", "online",
                 "online_interval_s", "online_overlay_max", "online_state_dir")


@pytest.mark.parametrize("flags,env", [
    ([], {}),
    (["--retrieval", "ann", "--ann-nlist", "64", "--ann-nprobe", "32", "--ann-rescore",
      "500", "--online", "--online-interval-s", "0.2", "--online-overlay-max", "100",
      "--online-state-dir", "state"], {}),
    (["--no-online", "--retrieval", "brute"],
     {"PIO_ONLINE_ENABLED": "1", "PIO_SERVING_RETRIEVAL": "ann"}),
    ([], {"PIO_SERVING_RETRIEVAL": "ANN", "PIO_SERVING_ANN_NPROBE": "8",
          "PIO_ONLINE_ENABLED": "true", "PIO_ONLINE_INTERVAL_S": "0.5",
          "PIO_ONLINE_OVERLAY_MAX": "12", "PIO_ONLINE_STATE_DIR": "/s"}),
    ([], {"PIO_SERVING_RETRIEVAL": "fast", "PIO_ONLINE_INTERVAL_S": "soon"}),
], ids=["defaults", "flags", "flags_over_env", "env", "malformed_env"])
def test_deploy_retrieval_and_online_flags_equal_jax(tmp_path, monkeypatch, flags, env):
    """`pio deploy`'s retrieval and online flags (and their environment
    defaults) build the ServerConfig the JAX package's `pio deploy`
    builds from the same arguments."""
    import predictionio_tpu.api.engine_server as jserver_mod

    import predictionio_tpu_torch.api.engine_server as pserver_mod

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (tmp_path / "engine.json").write_text(json.dumps(
        {"id": "e", "engineFactory": "x.engine_factory"}))
    configs = {}

    def capture(name):
        def create(storage=None, config=None, **kw):
            configs[name] = config
            raise _Captured()
        return create

    monkeypatch.setattr(pserver_mod, "create_engine_server", capture("port"))
    monkeypatch.setattr(jserver_mod, "create_engine_server", capture("jax"))
    args = ["deploy", "--ip", "127.0.0.1", "--port", "0", *flags]
    for name, main in (("port", pio.main), ("jax", jpio.main)):
        JaxStorage.reset_default()
        with pytest.raises(_Captured):
            main(args + (["--device", "cpu"] if name == "port" else []))
    JaxStorage.reset_default()
    got = {f: getattr(configs["port"], f) for f in DEPLOY_FIELDS}
    want = {f: getattr(configs["jax"], f) for f in DEPLOY_FIELDS}
    assert got == want
