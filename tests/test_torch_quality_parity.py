"""The port's quality-parity harness (``predictionio_tpu_torch/e2/quality.py``,
``data/movielens.py``) against the JAX package's on the CPU: the ML-100k
reconstruction and the sample-file loader give equal arrays; the NumPy
ALS-WR, the splits and the ranking metrics equal JAX's (the same NumPy
code); and ``compare_quality`` has JAX's keys, its NumPy keys equal, and
its device-path keys within JAX's own tolerances
(tests/test_quality_parity.py): held-out RMSE within ``RMSE_TOL`` of the
reference estimator's, MAP@10 inside the reference's seed band widened by
its width. With JAX's initial item factors injected, the port's ALS on
the same fold lands within ``SAME_INIT_RMSE_TOL`` of JAX's RMSE.

The ML-100k-shape runs (the JAX package's quality point, bench.py:
rank 10, 10 iterations, λ 0.05, 5 folds) are shared through
module-scoped fixtures.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.data import movielens as jml
from predictionio_tpu.e2 import quality as jq
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.data import movielens as pml
from predictionio_tpu_torch.e2 import quality as pq
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.parallel.mesh import Mesh

DATA = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                    "sample_movielens.txt")
#: tests/test_quality_parity.py:81: device-path vs reference held-out RMSE
RMSE_TOL = 0.05
#: the same fold and initial factors in both packages: bf16 products
#: summed in another order over 10 iterations (tests/test_torch_als.py
#: holds 5 iterations within 1e-3)
SAME_INIT_RMSE_TOL = 5e-3
POINT = dict(rank=10, iterations=10, lam=0.05, k_fold=5)


def _same_ds(a, b):
    for f in ("users", "items", "ratings"):
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (a.num_users, a.num_items, a.nnz) == (b.num_users, b.num_items, b.nnz)


def _small(mod, seed=3):
    return mod.synthesize_ml100k(seed=seed, num_users=200, num_items=400, num_ratings=12_000)


@pytest.fixture(scope="module")
def ml100k():
    ds = pml.synthesize_ml100k()
    _same_ds(ds, jml.synthesize_ml100k())
    return ds


@pytest.fixture(scope="module")
def port_point(ml100k):
    return pq.compare_quality(ml100k, device="cpu", **POINT)


@pytest.fixture(scope="module")
def jax_point(ml100k):
    return jq.compare_quality(jml.synthesize_ml100k(), **POINT)


class TestData:
    @pytest.mark.parametrize("kw", [
        dict(), dict(seed=5, num_users=200, num_items=400, num_ratings=12_000),
        dict(seed=1, selection_gamma=0.0, num_users=100, num_items=300, num_ratings=2_500)])
    def test_synthesize_ml100k_equals_jax(self, kw):
        _same_ds(pml.synthesize_ml100k(**kw), jml.synthesize_ml100k(**kw))

    def test_infeasible_size_raises_as_jax(self):
        for mod in (pml, jml):
            with pytest.raises(ValueError, match="feasible range"):
                mod.synthesize_ml100k(num_users=10, num_items=30, num_ratings=100)

    def test_sample_file_equals_jax(self):
        ds = pml.load_ratings_file(DATA)
        _same_ds(ds, jml.load_ratings_file(DATA))
        assert (ds.num_users, ds.num_items, ds.nnz) == (30, 100, 1501)
        assert list(ds.user_ids()[:3]) == list(jml.load_ratings_file(DATA).user_ids()[:3])

    def test_tab_separated_with_comments_equals_jax(self, tmp_path):
        rng = np.random.default_rng(0)
        path = tmp_path / "u.data"
        path.write_text("# provenance\n\n" + "".join(
            f"{u}\t{i}\t{r}\t88125000\n" for u, i, r in zip(
                rng.integers(1, 40, 300), rng.integers(1, 90, 300), rng.integers(1, 6, 300))))
        _same_ds(pml.load_ratings_file(str(path)), jml.load_ratings_file(str(path)))

    @pytest.mark.parametrize("fold", [0, 3])
    def test_kfold_split_equals_jax(self, fold):
        train, test = pq.kfold_split(_small(pml), k_fold=5, fold=fold)
        jtrain, jtest = jq.kfold_split(_small(jml), k_fold=5, fold=fold)
        _same_ds(train, jtrain)
        assert test == jtest


class TestNumpyEstimator:
    def test_als_wr_equals_jax(self):
        train, test = pq.kfold_split(_small(pml))
        jtrain, jtest = jq.kfold_split(_small(jml))
        U, V = pq.numpy_als_wr(train, rank=8, iterations=4, lam=0.05, seed=4)
        jU, jV = jq.numpy_als_wr(jtrain, rank=8, iterations=4, lam=0.05, seed=4)
        np.testing.assert_array_equal(U, jU)
        np.testing.assert_array_equal(V, jV)
        assert pq.test_rmse(U, V, test) == jq.test_rmse(jU, jV, jtest)
        assert pq.ranking_eval(pq.factor_score_fn(U, V), train, test) == \
            jq.ranking_eval(jq.factor_score_fn(jU, jV), jtrain, jtest)

    def test_rowloop_equals_jax_and_the_segment_solve(self):
        ds = pml.synthesize_ml100k(seed=2, num_users=60, num_items=120, num_ratings=2_000)
        jds = jml.synthesize_ml100k(seed=2, num_users=60, num_items=120, num_ratings=2_000)
        U, V = pq.numpy_als_wr_rowloop(ds, rank=12, iterations=2, lam=0.1)
        jU, jV = jq.numpy_als_wr_rowloop(jds, rank=12, iterations=2, lam=0.1)
        np.testing.assert_array_equal(U, jU)
        np.testing.assert_array_equal(V, jV)
        sU, sV = pq.numpy_als_wr(ds, rank=12, iterations=2, lam=0.1)
        np.testing.assert_allclose(U, sU, atol=1e-3)

    @pytest.mark.parametrize("k, threshold", [(10, 4.0), (5, 3.0)])
    def test_popularity_and_metrics_equal_jax(self, k, threshold):
        train, test = pq.kfold_split(_small(pml))
        jtrain, jtest = jq.kfold_split(_small(jml))
        got = pq.ranking_eval(pq.popularity_score_fn(train), train, test, k=k,
                              threshold=threshold)
        want = jq.ranking_eval(jq.popularity_score_fn(jtrain), jtrain, jtest, k=k,
                               threshold=threshold)
        assert got == want and got["evaluated_users"] > 0


class TestCompareQuality:
    def test_keys_and_numpy_values_equal_jax(self, port_point, jax_point):
        assert list(port_point) == list(jax_point)
        for key in ("map10_ref", "precision10_ref", "rmse_ref", "map10_popularity",
                    "evaluated_users"):
            assert port_point[key] == jax_point[key], key

    def test_rmse_matches_the_reference_estimator(self, port_point, jax_point):
        """The sharp gate of tests/test_quality_parity.py, and JAX's own
        device-path value within the same tolerance."""
        assert port_point["rmse_tpu"] == pytest.approx(port_point["rmse_ref"], abs=RMSE_TOL)
        assert port_point["rmse_tpu"] == pytest.approx(jax_point["rmse_tpu"], abs=RMSE_TOL)

    def test_map_within_reference_seed_spread(self, port_point, ml100k):
        train, test = pq.kfold_split(ml100k, k_fold=5)
        maps = []
        for seed in (11, 12, 13):
            U, V = pq.numpy_als_wr(train, rank=10, iterations=10, lam=0.05, seed=seed)
            maps.append(pq.ranking_eval(pq.factor_score_fn(U, V), train, test)["map@10"])
        lo, hi = min(maps), max(maps)
        width = max(hi - lo, 1e-4)
        assert lo - width <= port_point["map10_tpu"] <= hi + width, (port_point, maps)

    def test_implicit_beats_popularity(self, port_point, jax_point):
        """The ranking-wins axis: the port's implicit ALS beats popularity
        at the ML-100k shape, as JAX's does."""
        assert port_point["map10_implicit"] > port_point["map10_popularity"]
        assert jax_point["map10_implicit"] > jax_point["map10_popularity"]

    def test_implicit_beats_popularity_on_real_data(self):
        ds = pml.load_ratings_file(DATA)
        got = pq.implicit_vs_popularity_kfold(ds, device="cpu")
        want = jq.implicit_vs_popularity_kfold(jml.load_ratings_file(DATA))
        assert list(got) == list(want)
        assert got["map10_popularity"] == want["map10_popularity"]
        assert got["map10_implicit"] > got["map10_popularity"], got

    def test_same_initial_factors_same_rmse(self, ml100k):
        """compare_quality's explicit ALS on its fold, with JAX's initial
        item factors injected into the port's als_train."""
        train, test = pq.kfold_split(ml100k, k_fold=5, seed=3)
        key = jax.random.PRNGKey(3)
        item0 = np.asarray(jax.random.normal(key, (train.num_items, 10), dtype=jnp.float32)
                           / jnp.sqrt(jnp.float32(10)))
        f = pals.als_train(pals.RatingsCOO(train.users, train.items, train.ratings,
                                           train.num_users, train.num_items),
                           rank=10, iterations=10, lam=0.05, item0=item0, device="cpu")
        want = jals.als_train(jals.RatingsCOO(train.users, train.items, train.ratings,
                                              train.num_users, train.num_items),
                              rank=10, iterations=10, lam=0.05, seed=3)
        got_rmse = pq.test_rmse(f.user.numpy(), f.item.numpy(), test)
        want_rmse = jq.test_rmse(np.asarray(want.user), np.asarray(want.item), test)
        assert got_rmse == pytest.approx(want_rmse, abs=SAME_INIT_RMSE_TOL)

    def test_mesh_raises_naming_its_item(self):
        """A mesh trains over its positions: the fused layout solves each
        row where the unsharded run does, so every metric is the same
        (tests/test_torch_mesh_quality.py holds it against JAX's mesh)."""
        small = _small(pml)
        mesh = Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(2, 2), ("data", "model"))
        assert pq.compare_quality(small, mesh=mesh, device="cpu", **POINT) == \
            pq.compare_quality(small, device="cpu", **POINT)
        train, test = pq.kfold_split(small)
        assert pq.implicit_ranking_eval(train, test, mesh=mesh, device="cpu") == \
            pq.implicit_ranking_eval(train, test, device="cpu")

    def test_the_card_is_the_default(self, monkeypatch, ml100k):
        import torch

        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            pq.compare_quality(ml100k, rank=2, iterations=1)
