"""The port's masked top-k (``predictionio_tpu_torch/ops/topk.py``)
against the JAX package's ``ops/topk.py`` on the CPU, and the contracts
of tests/test_topk.py and tests/test_topk_dispatch.py: k clamps and
never asserts, seen items hide by scatter-min, padded seen slots change
nothing, the chunked path's empty slots carry -inf and sentinel indices
>= I, ``allow`` is (I,) or (B, I).

Scores are f32 products of the same inputs on both sides: values agree
within 1e-5, and on random inputs indices are compared where the gap to
each neighbour is above that tolerance. Exact ties (``TestTieOrder``:
duplicated factor rows, an all-equal row, ties across the cut, integer
factors whose products are exact on both sides) must come back in
``lax.top_k``'s order: item ids and order equal to JAX's on every path.
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


def _tied(B, I, K=6, distinct=7, seed=0):
    """Integer factors (exact f32 products on both sides) whose item rows
    repeat every ``distinct`` items: every score ties with many others."""
    rng = np.random.default_rng(seed)
    uv = rng.integers(-3, 4, (B, K)).astype(np.float32)
    itf = rng.integers(-3, 4, (distinct, K)).astype(np.float32)[np.arange(I) % distinct]
    cols = rng.integers(0, I, (B, 8)).astype(np.int32)
    mask = (rng.random((B, 8)) < 0.5).astype(np.float32)
    allow = (rng.random(I) < 0.9).astype(np.float32)
    return uv, itf, cols, mask, allow


def _assert_equal_topk(got, want, value_tol=0.0):
    """Ids and order equal; values equal (within ``value_tol`` where the
    two packages round the scores' arithmetic differently)."""
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=value_tol, atol=value_tol)


class TestTieOrder:
    """F1: every top-k path breaks ties as ``lax.top_k`` does."""

    @pytest.mark.parametrize("k", [1, 5, 64, 300])
    def test_topk_lowest_index_equals_lax_top_k(self, k):
        rng = np.random.default_rng(3)
        x = rng.integers(-2, 3, (5, 300)).astype(np.float32)
        x[0] = 0.0                                        # an all-equal row
        x[1, [50, 100, 140, 200, 250]] = 9.0              # ties straddling k=4
        x[2, ::3] = -np.inf
        x[3, 10], x[3, 20] = -0.0, 0.0                    # +0.0 ranks above -0.0
        import jax

        got = ptopk.topk_lowest_index(torch.from_numpy(x), k)
        want = jax.lax.top_k(jnp.asarray(x), k)
        _assert_equal_topk([t.numpy() for t in got], [np.asarray(a) for a in want])
        bf = torch.from_numpy(x).to(torch.bfloat16)       # other dtypes keep theirs
        assert ptopk.topk_lowest_index(bf, 3)[0].dtype == torch.bfloat16

    @pytest.mark.parametrize("allow_2d", [False, True], ids=["allow_1d", "allow_2d"])
    def test_recommend_topk(self, allow_2d):
        uv, itf, cols, mask, allow = _tied(4, 500)
        if allow_2d:
            allow = np.tile(allow, (4, 1))
            allow[1, :250] = 0.0
        for k in (3, 40, 500):
            _assert_equal_topk(*_both("recommend_topk", uv, itf, cols, mask, allow, k=k))

    @pytest.mark.parametrize("I, chunk", [(5000, 1024), (4096, 1024)],
                             ids=["overlap_tile", "divides"])
    def test_recommend_topk_chunked(self, I, chunk):
        uv, itf, cols, mask, allow = _tied(3, I, distinct=11)
        allow[:2000] = 0.0                    # ties that the carry meets in later tiles
        for k in (10, 200):
            _assert_equal_topk(*_both("recommend_topk_chunked", uv, itf, cols, mask, allow,
                                      k=k, chunk=chunk))

    def test_chunked_with_few_eligible_keeps_sentinels(self):
        uv, itf, cols, mask, allow = _tied(2, 5000, distinct=3)
        allow[:] = 0.0
        allow[[4, 2500, 4999]] = 1.0
        _assert_equal_topk(*_both("recommend_topk_chunked", uv, itf, cols, mask * 0, allow,
                                  k=8, chunk=1024))

    def test_similar_topk(self):
        uv, itf, cols, mask, allow = _tied(3, 600)
        # the cosines differ by an ulp between the packages; equal rows tie
        # exactly within each
        _assert_equal_topk(*_both("similar_topk", itf[:3], itf, cols[:3], mask[:3], allow,
                                  k=50), value_tol=1e-6)

    def test_topk_scores(self):
        x = np.repeat(np.random.default_rng(4).integers(0, 4, (3, 10)), 5, axis=1)
        got = [t.numpy() for t in ptopk.topk_scores(torch.from_numpy(x.astype(np.float32)), 17)]
        want = [np.asarray(a) for a in jtopk.topk_scores(jnp.asarray(x.astype(np.float32)), 17)]
        _assert_equal_topk(got, want)

    def test_predict_topk_batch_equals_jax(self):
        """A seqrec model (JAX's weights) whose item embeddings repeat:
        the port's next-item top-k equals ``lax.top_k`` over the port's
        own logits (equal rows give bitwise-equal logits), ids and order."""
        import jax

        from predictionio_tpu.models import seqrec as jseqrec
        from predictionio_tpu_torch.models import seqrec as pseqrec

        jcfg = jseqrec.SeqRecConfig(vocab=61, max_len=16, d_model=32, n_heads=2, n_layers=1,
                                    dtype=jnp.float32)
        params = jax.tree_util.tree_map(np.asarray, jseqrec.init_params(jax.random.PRNGKey(0),
                                                                        jcfg))
        params["item_emb"] = params["item_emb"][1 + np.arange(61) % 6]
        model = pseqrec.SeqRec.from_state(
            pseqrec.SeqRecConfig(vocab=61, max_len=16, d_model=32, n_heads=2, n_layers=1),
            pseqrec.params_from_jax(params), torch.device("cpu"))
        hist = torch.from_numpy(np.random.default_rng(5).integers(1, 61, (3, 16)))
        hist[2, 9:] = 0
        masks = torch.zeros((3, 61))
        masks[:, 0] = -1e30
        got_s, got_i = pseqrec.predict_topk_batch(model, hist, 25, masks)
        with torch.inference_mode():
            h = model(hist)
            last = (hist != 0).sum(1) - 1
            logits = pseqrec.logits_from_hidden(model, h[torch.arange(3), last]) + masks
        want_s, want_i = jax.lax.top_k(jnp.asarray(logits.numpy()), 25)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        assert len(set(got_s[0].tolist())) < 25          # the answer holds ties

    def test_als_probe_900_answers_equal_jax(self):
        """The re-anchor probe of ROADMAP queue 3's F1: JAX's ALS on 300
        users × 200 items (items 197-199 rated 5.0 by user 7 only, so
        they train to equal factor rows), the same factors in both
        ALSModels, every user at num 10, 50 and 200: all 900 answers
        equal, ids and order."""
        from predictionio_tpu.models import als as jmodels
        from predictionio_tpu.ops import als as jals
        from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
        from predictionio_tpu.utils.bimap import EntityIdIxMap as JaxEntityIdIxMap
        from predictionio_tpu_torch.models import als as pmodels

        rng = np.random.default_rng(1)
        rows = np.concatenate([rng.integers(0, 300, 4000), [7, 7, 7]]).astype(np.int32)
        cols = np.concatenate([rng.integers(0, 197, 4000), [197, 198, 199]]).astype(np.int32)
        vals = np.concatenate([rng.integers(1, 6, 4000), [5, 5, 5]]).astype(np.float32)
        f = jals.als_train(jals.RatingsCOO(rows, cols, vals, 300, 200), rank=10, iterations=5,
                           lam=0.05, seed=3)
        U, V = np.asarray(f.user), np.asarray(f.item)
        assert np.array_equal(V[197], V[198]) and np.array_equal(V[198], V[199])
        seen = {int(u): np.unique(cols[rows == u]) for u in np.unique(rows)}
        uids = {f"u{i}": i for i in range(300)}
        iids = {f"i{i}": i for i in range(200)}
        jax_model = jmodels.ALSModel(
            rank=10, user_factors=jnp.asarray(U), item_factors=jnp.asarray(V),
            user_ids=JaxEntityIdIxMap(JaxBiMap(uids)), item_ids=JaxEntityIdIxMap(JaxBiMap(iids)),
            seen_by_user=seen)
        port_model = pmodels.ALSModel.from_jax(U, V, uids, iids, seen, device="cpu")
        differ = [(u, n) for u in range(300) for n in (10, 50, 200)
                  if [i for i, _ in port_model.recommend(f"u{u}", n)]
                  != [i for i, _ in jax_model.recommend(f"u{u}", n)]]
        assert differ == []
