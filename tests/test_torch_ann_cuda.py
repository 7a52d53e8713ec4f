"""The ANN probe (``ops/ann.py``) on the card against the same call on the
CPU, and the ALS model's ANN path on the card.

Needs an NVIDIA card; every test skips without one. Imports no JAX, so
it runs on a machine without it:

    python -m pytest tests/test_torch_ann_cuda.py --noconftest
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.ops import ann

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _factors(n, seed, k=32):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, k)).astype(np.float32) * 2.0
    noise = rng.normal(size=(n, k)).astype(np.float32) * 0.5
    return (centers[rng.integers(0, 64, size=n)] + noise).astype(np.float32)


@pytest.mark.parametrize("b,nprobe", [(1, 0), (32, 0), (32, 8)])
def test_ann_topk_on_the_card_equals_the_cpu(cuda, b, nprobe):
    items = _factors(20_000, seed=1)
    users = _factors(b, seed=2)
    index = ann.build_index(items)
    nprobe = index.clamp_nprobe(nprobe)
    rng = np.random.default_rng(3)
    seen = torch.from_numpy(rng.integers(0, 20_000, (b, 16)))
    mask = torch.ones((b, 16))
    allow = torch.from_numpy((rng.random(20_000) < 0.9).astype(np.float32))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        out[dev.type] = ann.ann_topk(
            torch.from_numpy(users).to(dev), torch.from_numpy(items).to(dev),
            *index.device_arrays(dev), seen.to(dev), mask.to(dev), allow.to(dev), 100,
            nprobe)
    torch.testing.assert_close(out["cuda"][1].cpu(), out["cpu"][1], rtol=0, atol=0)
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0], rtol=1e-5, atol=1e-5)


def test_model_ann_at_full_probe_equals_brute_on_the_card(cuda):
    items = _factors(20_000, seed=4)
    users = _factors(16, seed=5)
    model = ALSModel.from_jax(users, items, {f"u{i}": i for i in range(16)},
                              {f"i{i}": i for i in range(20_000)}, {}, device=cuda)
    brute = [model.recommend(f"u{u}", 10) for u in range(16)]
    model.configure_retrieval("ann")
    model.ann_nprobe = model.ann_index.nlist
    assert [[i for i, _ in model.recommend(f"u{u}", 10)] for u in range(16)] == \
        [[i for i, _ in r] for r in brute]
