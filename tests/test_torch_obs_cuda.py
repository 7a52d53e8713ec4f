"""The port's device observability on the card (``obs/device.py``): a
``/metrics`` scrape in a fresh process leaves CUDA uninitialized (the
fork-safety rule of ``pio eval --parallel``); after a kernel launch the
memory gauges are nonzero, the peak is at least the current use and the
limit is the card's memory; a profiled region that launches the flash
kernel counts its FLOPs through the wrapper's hook.

Needs an NVIDIA card; every test skips without one. Imports no JAX:

    python -m pytest tests/test_torch_obs_cuda.py --noconftest
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent

SCRAPE = r"""
import torch
from predictionio_tpu_torch.api import engine_server
from predictionio_tpu_torch.obs.device import device_memory_collector, device_memory_snapshot
from predictionio_tpu_torch.obs.exporter import render_metrics
from predictionio_tpu_torch.utils.device import resolve_device
resolve_device(None)
assert device_memory_collector()() == [] and device_memory_snapshot() == {}
print(render_metrics(device_memory_collector()()).strip() == "", torch.cuda.is_initialized())
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def test_a_scrape_in_a_fresh_process_leaves_cuda_uninitialized(cuda):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", SCRAPE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False"]


def test_gauges_after_a_kernel_launch(cuda):
    from predictionio_tpu_torch.obs.device import device_memory_collector
    from predictionio_tpu_torch.ops import flash_attention as flash_ops

    q = torch.randn(2, 4, 256, 64, device=cuda, dtype=torch.bfloat16)
    before = flash_ops.LAUNCHES
    out = flash_ops.flash_attention(q, q, q, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1 and out.shape == q.shape
    samples = {m.name: m.samples[0] for m in device_memory_collector()()}
    (labels, in_use) = samples["pio_device_bytes_in_use"]
    assert labels["device"] == "cuda:0" and labels["kind"] == torch.cuda.get_device_name(0)
    assert in_use > 0
    assert samples["pio_device_peak_bytes_in_use"][1] >= in_use
    assert samples["pio_device_bytes_limit"][1] == \
        torch.cuda.get_device_properties(0).total_memory


def test_a_profiled_flash_launch_counts_its_pairs(cuda):
    from predictionio_tpu_torch.obs import device as pdevice
    from predictionio_tpu_torch.ops import flash_attention as flash_ops

    B, H, S, D = 2, 4, 256, 64
    q = torch.randn(B, H, S, D, device=cuda, dtype=torch.bfloat16)
    mask = torch.zeros(B, S, device=cuda)
    mask[0, :100] = 1
    mask[1, :7] = 1
    profiler = pdevice.TrainProfiler()
    profiler.begin(None, device=cuda)
    try:
        with pdevice.count_flops(), torch.no_grad():
            flash_ops.flash_attention(q, q, q, causal=True, kv_mask=mask)
    finally:
        report = profiler.finish(None)
    pairs = sum(S - j for j in range(100)) + sum(S - j for j in range(7))
    assert report["flops"]["executed"] == 4 * D * H * pairs
    assert report["deviceKind"] == torch.cuda.get_device_name(0)
    assert report["hbm"]["peakBytes"] > 0
