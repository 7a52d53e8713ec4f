"""The port's launcher stack (``bin_torch/``) on the CPU, the twin of the
JAX package's ``TestBinScripts`` (tests/test_tools.py): ``pio version``,
``pio-start-all`` (the event server alive on ``/``, its pidfile),
``pio-stop-all``, ``pio-daemon`` refusing a busy port and ``pio-shell``
binding ``storage``. Each step runs under ``bin/`` and under
``bin_torch/``; every line of their output is equal, the package name
and each run's own pids, ports and directories apart.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import time
import urllib.request
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
#: (event server, dashboard, admin server) ports of each stack
PORTS = {"bin": (27190, 27191, 27192), "bin_torch": (27193, 27194, 27195)}
#: the port each stack's pio-daemon finds taken
BUSY = {"bin": 27196, "bin_torch": 27197}


def _env(tmp_path: Path, stack: str) -> dict:
    base = tmp_path / stack
    base.mkdir(exist_ok=True)
    es, dash, admin = PORTS[stack]
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_")}
    env.update(PIO_FS_BASEDIR=str(base), PIO_PID_DIR=str(base), PIO_LOG_DIR=str(base),
               PIO_EVENTSERVER_PORT=str(es), PIO_DASHBOARD_PORT=str(dash),
               PIO_ADMINSERVER_PORT=str(admin), JAX_PLATFORMS="cpu")
    return env


def _normal(text: str, env: dict) -> list[str]:
    """The lines of ``text`` with the run's own values named: its
    directory, ports and pids, and the package."""
    text = text.replace(env["PIO_PID_DIR"], "<dir>")
    for role in ("EVENTSERVER", "DASHBOARD", "ADMINSERVER"):
        text = re.sub(rf"\b{env[f'PIO_{role}_PORT']}\b", f"<{role.lower()}>", text)
    text = re.sub(r"\bpid \d+", "pid <pid>", text)
    return text.replace("predictionio_tpu_torch", "predictionio_tpu").splitlines()


def _run(stack: str, script: str, env: dict, *args: str, stdin: str | None = None):
    return subprocess.run([str(REPO / stack / script), *args], env=env, input=stdin,
                          capture_output=True, text=True, timeout=180)


def _alive(port: int) -> dict | None:
    for _ in range(120):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=2) as r:
                return json.loads(r.read())
        except OSError:
            time.sleep(0.5)
    return None


def test_bin_torch_pio_version_equals_bin(tmp_path):
    outs = {stack: _run(stack, "pio", _env(tmp_path, stack), "version")
            for stack in PORTS}
    assert all(o.returncode == 0 for o in outs.values())
    assert outs["bin_torch"].stdout == outs["bin"].stdout == "0.1.0\n"


def _lifecycle(tmp_path: Path, stack: str) -> tuple[list[str], list[str], dict | None, bool]:
    env = _env(tmp_path, stack)
    start = _run(stack, "pio-start-all", env)
    try:
        assert start.returncode == 0, start.stdout + start.stderr
        alive = _alive(PORTS[stack][0])
        pidfile = (Path(env["PIO_PID_DIR"]) / "eventserver.pid").exists()
    finally:
        stop = _run(stack, "pio-stop-all", env)
    assert not (Path(env["PIO_PID_DIR"]) / "eventserver.pid").exists()
    return _normal(start.stdout, env), _normal(stop.stdout, env), alive, pidfile


def test_start_all_and_stop_all_as_bin(tmp_path):
    got, want = (_lifecycle(tmp_path, stack) for stack in ("bin_torch", "bin"))
    start, stop, alive, pidfile = got
    assert alive == {"status": "alive"} and pidfile
    assert "Stopped eventserver (pid <pid>)" in stop
    assert start == [f"Started 'pio {name} --port <{name}>' (pid <pid>, pidfile <dir>/{name}.pid)"
                     for name in ("eventserver", "dashboard", "adminserver")]
    assert got == want


def test_pio_daemon_refuses_a_busy_port_as_bin(tmp_path):
    outs = {}
    for stack in PORTS:
        env = dict(_env(tmp_path, stack), PIO_EVENTSERVER_PORT=str(BUSY[stack]))
        port = BUSY[stack]
        with socket.socket() as squatter:
            squatter.bind(("127.0.0.1", port))
            squatter.listen()
            pidfile = Path(env["PIO_PID_DIR"]) / "eventserver.pid"
            out = _run(stack, "pio-daemon", env, str(pidfile), "eventserver", "--port", str(port))
        assert out.returncode == 1 and not pidfile.exists()
        outs[stack] = (_normal(out.stdout, env), _normal(out.stderr, env))
    assert outs["bin_torch"] == outs["bin"] == (
        [], ["Cannot start 'pio eventserver --port <eventserver>': port <eventserver> "
             "is already in use"])


@pytest.mark.parametrize("line", ["print('storage:', type(storage).__name__)",
                                  "print('events:', EventStore.__name__)"])
def test_pio_shell_binds_storage_as_bin(tmp_path, line):
    outs = {}
    for stack in PORTS:
        env = _env(tmp_path, stack)
        out = _run(stack, "pio-shell", env, stdin=line + "\n")
        assert out.returncode == 0, out.stdout + out.stderr
        assert f"{'predictionio_tpu_torch' if stack == 'bin_torch' else 'predictionio_tpu'} " \
            "0.1.0 shell" in out.stdout.splitlines()
        outs[stack] = _normal(out.stdout, env)
    assert outs["bin_torch"][:2] == ["predictionio_tpu 0.1.0 shell",
                                     "bound: storage (Storage.default()), EventStore"]
    assert outs["bin_torch"] == outs["bin"]
    assert outs["bin_torch"][2] in ("storage: Storage", "events: EventStore")
