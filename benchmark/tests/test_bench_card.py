"""The command as the driver runs it. Without a card it exits non-zero
and prints no result; on the card (``cuda``-marked, decided inside the
test) a short run of each cell comes out correct with a sound line."""

from __future__ import annotations

import json
import subprocess
import sys

import bench_tiny
import pytest

from benchmark.harness.manifest import load_manifest

CELLS = [w["name"] for w in load_manifest()["workloads"]]


def _run(cell: str, seconds: float, trace: int, env=None) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 77),
           "--seconds", str(seconds), "--trace", str(trace)]
    return subprocess.run(cmd, cwd=bench_tiny.ROOT, capture_output=True, text=True,
                          timeout=600, env=env)


def test_without_a_card_the_run_fails_and_prints_no_result():
    import os

    import torch

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if torch.cuda.is_available():
        env["CUDA_VISIBLE_DEVICES"] = "-1"
    proc = _run(CELLS[0], 1, 0, env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for trace in (0, 1):
        proc = _run(cell, 3, trace)
        assert proc.returncode == 0, proc.stderr[-4000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line["checks"]
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
        assert line["metrics"]
