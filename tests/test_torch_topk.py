"""The port's masked top-k (``predictionio_tpu_torch/ops/topk.py``)
against the JAX package's ``ops/topk.py`` on the CPU, and the contracts
of tests/test_topk.py and tests/test_topk_dispatch.py: k clamps and
never asserts, seen items hide by scatter-min, padded seen slots change
nothing, the chunked path's empty slots carry -inf and sentinel indices
>= I, ``allow`` is (I,) or (B, I).

Scores are f32 products of the same inputs on both sides: values agree
within 1e-5; ``torch.topk`` and ``lax.top_k`` may order equal scores
differently, so indices are compared where the gap to each neighbour is
above that tolerance.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import topk as jtopk
from predictionio_tpu_torch.ops import topk as ptopk

TOL = 1e-5


def _setup(B, I, K=8, S=16, seed=0, allow_2d=False):
    rng = np.random.default_rng(seed)
    uv = rng.standard_normal((B, K)).astype(np.float32)
    itf = rng.standard_normal((I, K)).astype(np.float32)
    cols = rng.integers(0, I, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.5).astype(np.float32)
    shape = (B, I) if allow_2d else (I,)
    allow = (rng.random(shape) < 0.9).astype(np.float32)
    return uv, itf, cols, mask, allow


def _both(fn_name, *arrays, k, **kw):
    """(port, JAX) results of the same function on the same arrays."""
    got = getattr(ptopk, fn_name)(*map(torch.from_numpy, arrays), k, **kw)
    want = getattr(jtopk, fn_name)(*map(jnp.asarray, arrays), k, **kw)
    return ([t.numpy() for t in got], [np.asarray(a) for a in want])


def _assert_same_topk(got, want):
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gi.shape == wi.shape
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=TOL, atol=TOL)
    gap = np.abs(np.diff(np.where(finite, wv, -1e30), axis=1))
    clear = np.ones_like(finite)
    clear[:, :-1] &= gap > TOL
    clear[:, 1:] &= gap > TOL
    clear &= finite
    np.testing.assert_array_equal(gi[clear], wi[clear])


class TestAgainstJax:
    @pytest.mark.parametrize("allow_2d", [False, True], ids=["allow_1d", "allow_2d"])
    @pytest.mark.parametrize("B, I, k", [(1, 50, 10), (4, 200, 5), (7, 1000, 32)])
    def test_recommend_topk(self, B, I, k, allow_2d):
        _assert_same_topk(*_both("recommend_topk", *_setup(B, I, allow_2d=allow_2d), k=k))

    @pytest.mark.parametrize("I, chunk", [(5000, 1024), (4096, 1024), (3000, 4096)],
                             ids=["overlap_tile", "divides", "one_tile"])
    def test_recommend_topk_chunked(self, I, chunk):
        got, want = _both("recommend_topk_chunked", *_setup(6, I, S=24), k=10, chunk=chunk)
        _assert_same_topk(got, want)

    def test_similar_topk(self):
        uv, itf, cols, mask, allow = _setup(3, 300, S=4)
        _assert_same_topk(*_both("similar_topk", itf[:3] * 2.0, itf, cols, mask, allow, k=10))

    def test_topk_scores(self):
        scores = np.random.default_rng(1).standard_normal((3, 40)).astype(np.float32)
        got = [t.numpy() for t in ptopk.topk_scores(torch.from_numpy(scores), 7)]
        want = [np.asarray(a) for a in jtopk.topk_scores(jnp.asarray(scores), 7)]
        _assert_same_topk(got, want)

    @pytest.mark.parametrize("b", list(range(0, 20)) + [31, 32, 33, 255, 256, 257, 511, 512, 513, 4096])
    def test_serving_batch(self, b):
        assert ptopk.serving_batch(b) == jtopk.serving_batch(b)

    @pytest.mark.parametrize("k", [1, 10, 11, 100, 321, 1000, 1001, 5000])
    @pytest.mark.parametrize("n_max", [7, 500, 1 << 62])
    def test_serving_k(self, k, n_max):
        assert ptopk.serving_k(k, n_max) == jtopk.serving_k(k, n_max)

    def test_menus_and_thresholds_are_jax_values(self):
        assert ptopk._SEEN_WIDTHS == jtopk._SEEN_WIDTHS
        assert ptopk.BATCH_WIDTHS == jtopk.BATCH_WIDTHS
        assert (ptopk._MIN_ITEMS, ptopk._MIN_BATCH) == (jtopk._MIN_ITEMS, jtopk._MIN_BATCH)

    @pytest.mark.parametrize("width, last", [(513, 30), (513, 0), (200, 150), (600, 599),
                                             (512, 3), (40, 39)])
    def test_trim_seen(self, width, last):
        cols = np.arange(3 * width, dtype=np.int32).reshape(3, width)
        mask = np.zeros((3, width), np.float32)
        mask[1, last] = 1.0
        gc, gm = ptopk._trim_seen(cols, mask)
        wc, wm = jtopk._trim_seen(cols, mask)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gm, wm)

    def test_trim_seen_leaves_tensors(self):
        cols, mask = torch.zeros((2, 513), dtype=torch.int32), torch.zeros((2, 513))
        assert ptopk._trim_seen(cols, mask)[1] is mask


class TestContracts:
    def test_k_clamps_on_every_path(self):
        uv, itf, cols, mask, allow = map(torch.from_numpy, _setup(3, 7, S=4))
        assert ptopk.recommend_topk(uv, itf, cols, mask, allow, 32)[0].shape == (3, 7)
        for chunk in (64, 4):
            v, i = ptopk.recommend_topk_chunked(uv, itf, cols, mask, allow, 99, chunk=chunk)
            assert v.shape == i.shape == (3, 7)
        assert ptopk.recommend_topk_fused(uv, itf, cols.numpy(), mask.numpy(), allow,
                                          40)[0].shape == (3, 7)
        assert ptopk.similar_topk(itf[:2], itf, cols[:2], mask[:2], allow, 100)[0].shape == (2, 7)
        assert ptopk.topk_scores(torch.ones(2, 6), 50)[0].shape == (2, 6)

    def test_every_candidate_masked(self):
        uv, itf, cols, mask, _ = map(torch.from_numpy, _setup(2, 3, S=4))
        vals, _ = ptopk.recommend_topk(uv, itf, cols, mask, torch.zeros(3), 8)
        assert vals.shape == (2, 3) and not torch.isfinite(vals).any()

    def test_seen_hidden_and_padded_slots_change_nothing(self):
        """Real seen slots hide their item; padded slots (mask 0) point at
        item 0 and must leave it untouched."""
        uv = torch.ones(1, 2)
        itf = torch.tensor([[5.0, 5.0], [4.0, 4.0], [3.0, 3.0], [2.0, 2.0]])
        cols = torch.tensor([[1, 0, 0, 0]])
        mask = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
        vals, idx = ptopk.recommend_topk(uv, itf, cols, mask, torch.ones(4), 4)
        assert idx[0, :3].tolist() == [0, 2, 3] and vals[0, 3].item() == float("-inf")
        for chunk in (2, 3):
            v, i = ptopk.recommend_topk_chunked(uv, itf, cols, mask, torch.ones(4), 4,
                                                chunk=chunk)
            assert i[0, :3].tolist() == [0, 2, 3] and not torch.isfinite(v[0, 3])
            assert i[0, 3].item() >= 4    # a sentinel, never a real item

    def test_chunked_sentinels_never_collide(self):
        uv, itf, cols, mask, allow = map(torch.from_numpy, _setup(4, 5000, S=24))
        allow = torch.zeros(5000)
        allow[[3, 1500, 4999]] = 1.0          # three eligible items
        mask.zero_()
        v, i = ptopk.recommend_topk_chunked(uv, itf, cols, mask, allow, 10, chunk=1024)
        finite = torch.isfinite(v)
        assert finite.sum(1).tolist() == [3, 3, 3, 3]
        assert (i[~finite] >= 5000).all() and len(set(i[0].tolist())) == 10
        fv, fi = ptopk.recommend_topk(uv, itf, cols, mask, allow, 10)
        assert torch.equal(fi[finite], i[finite])

    def test_dispatch_takes_chunked_above_the_thresholds(self, monkeypatch):
        calls = []
        real = ptopk.recommend_topk_chunked
        monkeypatch.setattr(ptopk, "recommend_topk_chunked",
                            lambda *a, **k: calls.append("chunked") or real(*a, **k))
        monkeypatch.setattr(ptopk, "_MIN_ITEMS", 100)
        monkeypatch.setattr(ptopk, "_MIN_BATCH", 2)
        uv, itf, cols, mask, allow = _setup(4, 200, S=513)
        mask[:, 40:] = 0.0
        got = ptopk.recommend_topk_fused(torch.from_numpy(uv), torch.from_numpy(itf), cols,
                                         mask, torch.from_numpy(allow), 5)
        assert calls == ["chunked"]
        want = ptopk.recommend_topk(*map(torch.from_numpy, (uv, itf, cols, mask, allow)), 5)
        assert torch.equal(got[1], want[1])
        calls.clear()   # a per-query (B, I) allow stays on the flat path
        ptopk.recommend_topk_fused(torch.from_numpy(uv), torch.from_numpy(itf), cols, mask,
                                   torch.ones(4, 200), 5)
        assert calls == []
