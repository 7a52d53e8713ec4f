"""The port's ANN retrieval (``ops/ann.py`` and the retrieval half of
``models/als.py``) beside the JAX package's, on the CPU (lane:
tests/test_ann.py).

The same seeded factor tables go through both packages:

- the build: ``build_index`` gives the same arrays, array for array;
- the probes: ``ann_topk`` and ``ann_similar_topk`` return JAX's ids in
  JAX's order, values within 1e-5, under seen lists, 1-D and 2-D
  ``allow``, several probe counts and a rescore budget;
- at ``nprobe = nlist`` the answers equal the port's brute force;
- ties (factor rows that repeat) and sentinel ids;
- the model: ``recommend``/``similar``/``batch_topk`` through the index,
  and persistence across the two packages, ``ann/`` included;
- ``quality_vs_brute`` gives JAX's numbers.

The card's counterpart is tests/test_torch_ann_cuda.py.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models import als as jmodels
from predictionio_tpu.ops import ann as jann
from predictionio_tpu.ops import topk as jtopk
from predictionio_tpu.utils import checkpoint as jckpt
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu.utils.bimap import EntityIdIxMap as JaxEntityIdIxMap
from predictionio_tpu_torch.models import als as pmodels
from predictionio_tpu_torch.ops import ann as pann
from predictionio_tpu_torch.ops import topk as ptopk
from predictionio_tpu_torch.utils import checkpoint as pckpt

pytestmark = pytest.mark.ann

K = 16
CPU = torch.device("cpu")
VAL_TOL = 1e-5


def _factors(n, n_clusters=64, seed=0, k=K):
    """Mixture-of-gaussians rows, the clustered shape of ALS factor
    tables (the JAX test's generator)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, k)).astype(np.float32) * 2.0
    asg = rng.integers(0, n_clusters, size=n)
    noise = rng.normal(size=(n, k)).astype(np.float32) * 0.5
    return (centers[asg] + noise).astype(np.float32)


def _both_indexes(items, **kw):
    return jann.build_index(items, **kw), pann.build_index(items, **kw)


def _jax_args(index):
    return index.device_arrays()


def _port_args(index):
    return index.device_arrays(CPU)


def _assert_same(got, want, tol=VAL_TOL):
    """(values, ids) of the port against JAX's: ids and order exact,
    values within ``tol`` where finite, -inf where JAX's is."""
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gv.shape == wv.shape
    np.testing.assert_array_equal(gi, wi.astype(np.int64))
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the build (host NumPy)
# ---------------------------------------------------------------------------


class TestBuild:
    @pytest.mark.parametrize("n,nlist,seed,k", [(4096, 0, 0, 16), (8192, 32, 3, 8),
                                                (20000, 0, 1, 32)])
    def test_arrays_equal_jax(self, n, nlist, seed, k):
        items = _factors(n, seed=seed, k=k)
        want, got = _both_indexes(items, nlist=nlist, seed=seed)
        assert (got.nlist, got.n_items, got.max_cell) == (want.nlist, want.n_items,
                                                          want.max_cell)
        for name, arr in want.to_arrays().items():
            np.testing.assert_array_equal(got.to_arrays()[name], arr, err_msg=name)
            assert got.to_arrays()[name].dtype == arr.dtype, name

    def test_tensor_input_builds_the_numpy_index(self):
        items = _factors(4096, seed=5)
        a = pann.build_index(items)
        b = pann.build_index(torch.from_numpy(items))
        for name, arr in a.to_arrays().items():
            np.testing.assert_array_equal(b.to_arrays()[name], arr)

    @pytest.mark.parametrize("n", [0, 100, 1023, 1024, 4096, 100_000, 1_000_000, 10**9])
    def test_sizing_helpers_equal_jax(self, n):
        assert pann.auto_nlist(n) == jann.auto_nlist(n)
        nlist = pann.auto_nlist(n)
        assert pann.auto_nprobe(nlist) == jann.auto_nprobe(nlist)
        for nprobe, rescore in ((1, 0), (16, 0), (64, 128), (nlist, 0)):
            assert pann._budget_width(n, nlist, nprobe, rescore) == \
                jann._budget_width(n, nlist, nprobe, rescore)

    def test_small_catalog_and_oversized_nlist(self):
        assert pann.build_index(_factors(256)) is None
        want, got = _both_indexes(_factors(2048), nlist=1024, seed=1, sample=512)
        assert got.nlist == want.nlist == 512
        np.testing.assert_array_equal(got.centroids, want.centroids)

    def test_clamp_and_width_equal_jax(self):
        want, got = _both_indexes(_factors(4096, seed=2))
        for nprobe in (0, 1, 3, 16, 1000):
            assert got.clamp_nprobe(nprobe) == want.clamp_nprobe(nprobe)
            for rescore in (0, 50, 10_000):
                assert got.shortlist_width(nprobe, rescore) == \
                    want.shortlist_width(nprobe, rescore)


# ---------------------------------------------------------------------------
# the probes (torch on the CPU against the JAX functions)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def catalog():
    """(items, users, JAX index, port index) at 8,192 items, rank 16."""
    items = _factors(8192, seed=6)
    users = _factors(24, seed=7)
    jidx, pidx = _both_indexes(items, seed=0)
    return items, users, jidx, pidx


def _masks(b, n_items, allow_kind, seed):
    rng = np.random.default_rng(seed)
    seen = rng.integers(0, n_items, (b, 8)).astype(np.int32)
    seen_mask = (rng.random((b, 8)) < 0.7).astype(np.float32)
    if allow_kind == "none":
        allow = np.ones((n_items,), dtype=np.float32)
    elif allow_kind == "1d":
        allow = (rng.random(n_items) < 0.8).astype(np.float32)
    else:
        allow = (rng.random((b, n_items)) < 0.8).astype(np.float32)
    return seen, seen_mask, allow


class TestProbes:
    @pytest.mark.parametrize("allow_kind", ["none", "1d", "2d"])
    @pytest.mark.parametrize("nprobe,rescore,b", [(0, 0, 1), (0, 0, 24), (4, 0, 24),
                                                  (64, 0, 24), (0, 128, 24)])
    def test_ann_topk_equals_jax(self, catalog, allow_kind, nprobe, rescore, b):
        items, users, jidx, pidx = catalog
        nprobe = jidx.clamp_nprobe(nprobe)
        seen, seen_mask, allow = _masks(b, len(items), allow_kind, seed=nprobe + b)
        uv = users[:b]
        want = jann.ann_topk(jnp.asarray(uv), jnp.asarray(items), *_jax_args(jidx),
                             jnp.asarray(seen), jnp.asarray(seen_mask), jnp.asarray(allow),
                             32, nprobe, rescore)
        got = pann.ann_topk(torch.from_numpy(uv), torch.from_numpy(items), *_port_args(pidx),
                            torch.from_numpy(seen), torch.from_numpy(seen_mask),
                            torch.from_numpy(allow), 32, nprobe, rescore)
        _assert_same(got, want)
        # masked items never come back; masked slots carry sentinels
        gv, gi = (t.numpy() for t in got)
        for r in range(b):
            real = set(gi[r][np.isfinite(gv[r])].tolist())
            assert not real & set(seen[r][seen_mask[r] > 0].tolist())
            row_allow = allow if allow.ndim == 1 else allow[r]
            assert all(row_allow[i] > 0 for i in real)
        assert (gi[~np.isfinite(gv)] >= len(items)).all()

    @pytest.mark.parametrize("allow_kind", ["none", "1d", "2d"])
    @pytest.mark.parametrize("nprobe", [0, 8])
    def test_ann_similar_topk_equals_jax(self, catalog, allow_kind, nprobe):
        items, _, jidx, pidx = catalog
        nprobe = jidx.clamp_nprobe(nprobe)
        b = 8
        _, _, allow = _masks(b, len(items), allow_kind, seed=3)
        qv = items[:b] * np.float32(1.5)
        ex = np.arange(b, dtype=np.int32)[:, None]
        ex_mask = np.ones((b, 1), dtype=np.float32)
        want = jann.ann_similar_topk(jnp.asarray(qv), jnp.asarray(items), *_jax_args(jidx),
                                     jnp.asarray(ex), jnp.asarray(ex_mask),
                                     jnp.asarray(allow), 10, nprobe)
        got = pann.ann_similar_topk(torch.from_numpy(qv), torch.from_numpy(items),
                                    *_port_args(pidx), torch.from_numpy(ex),
                                    torch.from_numpy(ex_mask), torch.from_numpy(allow), 10,
                                    nprobe)
        _assert_same(got, want)

    def test_full_probe_equals_port_brute(self, catalog):
        items, users, _, pidx = catalog
        uv, itf = torch.from_numpy(users), torch.from_numpy(items)
        b = users.shape[0]
        seen, seen_mask, allow = (torch.from_numpy(a) for a in
                                  _masks(b, len(items), "1d", seed=11))
        bv, bi = ptopk.recommend_topk(uv, itf, seen, seen_mask, allow, 10)
        av, ai = pann.ann_topk(uv, itf, *_port_args(pidx), seen, seen_mask, allow, 10,
                               pidx.nlist)
        torch.testing.assert_close(ai, bi, rtol=0, atol=0)
        torch.testing.assert_close(av, bv, rtol=1e-6, atol=1e-6)
        qv = itf[:8]
        ex = torch.arange(8)[:, None]
        ex_mask = torch.ones((8, 1))
        bv, bi = ptopk.similar_topk(qv, itf, ex, ex_mask, allow, 10)
        av, ai = pann.ann_similar_topk(qv, itf, *_port_args(pidx), ex, ex_mask, allow, 10,
                                       pidx.nlist)
        torch.testing.assert_close(ai, bi, rtol=0, atol=0)
        torch.testing.assert_close(av, bv, rtol=1e-6, atol=1e-6)

    def test_rescore_budget_truncates_as_jax(self, catalog):
        items, users, jidx, pidx = catalog
        nprobe = pidx.clamp_nprobe(0)
        assert pidx.shortlist_width(nprobe, rescore=128) == 128
        args = (np.zeros((4, 1), np.int32), np.zeros((4, 1), np.float32),
                np.ones((len(items),), np.float32))
        want = jann.ann_topk(jnp.asarray(users[:4]), jnp.asarray(items), *_jax_args(jidx),
                             *(jnp.asarray(a) for a in args), 256, nprobe, 128)
        got = pann.ann_topk(torch.from_numpy(users[:4]), torch.from_numpy(items),
                            *_port_args(pidx), *(torch.from_numpy(a) for a in args), 256,
                            nprobe, 128)
        assert tuple(got[0].shape) == (4, 128)
        _assert_same(got, want)

    def test_repeated_rows_keep_the_tie_order_and_sentinels(self):
        """Integer factors whose rows repeat every 97 items score in exact
        ties (centroid scores too); an allow vector leaves fewer eligible
        items than k, so sentinels fill the tail."""
        rng = np.random.default_rng(13)
        base = rng.integers(-3, 4, (97, 8)).astype(np.float32)
        items = base[np.arange(4096) % 97]
        users = rng.integers(-3, 4, (6, 8)).astype(np.float32)
        jidx, pidx = _both_indexes(items, seed=2)
        for name, arr in jidx.to_arrays().items():
            np.testing.assert_array_equal(pidx.to_arrays()[name], arr)
        allow = np.zeros((4096,), dtype=np.float32)
        allow[rng.choice(4096, 300, replace=False)] = 1.0
        seen = np.zeros((6, 1), np.int32)
        seen_mask = np.zeros((6, 1), np.float32)
        for nprobe, k in ((pidx.clamp_nprobe(0), 100), (3, 320), (pidx.nlist, 1000)):
            want = jann.ann_topk(jnp.asarray(users), jnp.asarray(items), *_jax_args(jidx),
                                 jnp.asarray(seen), jnp.asarray(seen_mask),
                                 jnp.asarray(allow), k, nprobe)
            got = pann.ann_topk(torch.from_numpy(users), torch.from_numpy(items),
                                *_port_args(pidx), torch.from_numpy(seen),
                                torch.from_numpy(seen_mask), torch.from_numpy(allow), k,
                                nprobe)
            _assert_same(got, want, tol=0)
            # 300 eligible items: the larger k end in sentinels
            assert (~np.isfinite(got[0].numpy())).any() == (k > 300)


# ---------------------------------------------------------------------------
# the model: retrieval through the index
# ---------------------------------------------------------------------------


def _models(n_items=4096, n_users=32, seed=0, k=K):
    """(port model, JAX model) of the same seeded factors and seen lists."""
    items = _factors(n_items, seed=seed, k=k)
    users = _factors(n_users, seed=seed + 1, k=k)
    rng = np.random.default_rng(seed + 2)
    seen = {u: np.sort(rng.choice(n_items, int(rng.integers(0, 40)), replace=False)
                       ).astype(np.int32) for u in range(n_users)}
    uids = {f"u{i}": i for i in range(n_users)}
    iids = {f"i{i}": i for i in range(n_items)}
    port = pmodels.ALSModel.from_jax(users, items, uids, iids, seen, device="cpu")
    jax_model = jmodels.ALSModel(
        rank=k, user_factors=jnp.asarray(users), item_factors=jnp.asarray(items),
        user_ids=JaxEntityIdIxMap(JaxBiMap(uids)), item_ids=JaxEntityIdIxMap(JaxBiMap(iids)),
        seen_by_user=seen)
    return port, jax_model


def _same_answers(got, want, tol=VAL_TOL):
    """Items and order equal; scores within ``tol`` (relative and
    absolute, as in ``_assert_same``)."""
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=tol, atol=tol)


class TestModel:
    @pytest.mark.parametrize("nprobe", [0, 5])
    def test_recommend_and_similar_equal_jax_under_ann(self, nprobe):
        port, jax_model = _models(seed=20)
        pcalls, jcalls = [], []
        port.configure_retrieval("ann", nprobe=nprobe,
                                 observer=lambda w, q: pcalls.append((w, q)))
        jax_model.configure_retrieval("ann", nprobe=nprobe,
                                      observer=lambda w, q: jcalls.append((w, q)))
        assert port.ann_enabled and jax_model.ann_enabled
        for name, arr in jax_model.ann_index.to_arrays().items():
            np.testing.assert_array_equal(port.ann_index.to_arrays()[name], arr)
        rng = np.random.default_rng(21)
        allow = (rng.random(4096) < 0.7).astype(np.float32)
        for u in range(0, 32, 3):
            _same_answers(port.recommend(f"u{u}", 10), jax_model.recommend(f"u{u}", 10))
            _same_answers(port.recommend(f"u{u}", 100, allow=allow),
                          jax_model.recommend(f"u{u}", 100, allow=allow))
            _same_answers(port.recommend(f"u{u}", 10, exclude_seen=False),
                          jax_model.recommend(f"u{u}", 10, exclude_seen=False))
        for query in (["i0"], ["i1", "i2", "nope"], [f"i{j}" for j in range(0, 600, 7)]):
            _same_answers(port.similar(query, 10), jax_model.similar(query, 10))
        assert port.recommend("nobody", 10) == jax_model.recommend("nobody", 10) == []
        assert pcalls == jcalls and pcalls

    def test_batch_topk_equals_jax_under_ann(self):
        port, jax_model = _models(seed=22)
        pcalls, jcalls = [], []
        port.configure_retrieval("ann", observer=lambda w, q: pcalls.append((w, q)))
        jax_model.configure_retrieval("ann", observer=lambda w, q: jcalls.append((w, q)))
        uixs = np.arange(8, dtype=np.int32)
        cols = np.zeros((8, 32), dtype=np.int32)
        mask = np.zeros((8, 32), dtype=np.float32)
        for j in range(8):
            s = port.seen_by_user[j][:32]
            cols[j, : len(s)] = s
            mask[j, : len(s)] = 1.0
        _assert_same(port.batch_topk(uixs, cols, mask, None, 32),
                     jax_model.batch_topk(uixs, cols, mask, None, 32))
        assert pcalls == jcalls == [(port.ann_index.shortlist_width(
            port.ann_index.clamp_nprobe(0)), 8)]

    def test_full_probe_recommend_and_similar_match_brute(self):
        port, _ = _models(seed=23)
        brute = [port.recommend(f"u{u}", 10) for u in range(8)]
        brute_sim = port.similar(["i0", "i1"], 10)
        port.configure_retrieval("ann")
        port.ann_nprobe = port.ann_index.nlist
        assert [port.recommend(f"u{u}", 10) for u in range(8)] == brute
        assert port.similar(["i0", "i1"], 10) == brute_sim

    def test_small_catalog_degrades_to_brute(self):
        port, _ = _models(n_items=128, seed=24)
        port.configure_retrieval("ann")
        assert not port.ann_enabled and port.retrieval == "brute"
        assert port.recommend("u0", 5)


# ---------------------------------------------------------------------------
# persistence across the two packages
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_npz(monkeypatch):
    """The JAX package's checkpoints in npz, the format the port reads."""
    monkeypatch.setattr(jckpt, "_ocp", lambda: None)


def _meta(directory):
    with open(directory / "model.json") as f:
        return json.load(f)


class TestPersistence:
    def test_port_save_writes_what_jax_writes(self, tmp_path, jax_npz):
        port, jax_model = _models(seed=30)
        port.save(str(tmp_path / "port"))
        jax_model.save(str(tmp_path / "jax"))
        assert _meta(tmp_path / "port") == _meta(tmp_path / "jax")
        assert _meta(tmp_path / "port")["ann"] == {"nlist": port.ann_index.nlist,
                                                   "n_items": 4096}
        a = pckpt.load_sharded(str(tmp_path / "port" / "ann"))
        b = pckpt.load_sharded(str(tmp_path / "jax" / "ann"))
        assert set(a) == set(b) == {"centroids", "flat_items", "flat_vecs", "cell_offset"}
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])

    def test_round_trips_across_the_packages(self, tmp_path, jax_npz):
        port, jax_model = _models(seed=31)
        port.save(str(tmp_path / "port"))
        jax_model.save(str(tmp_path / "jax"))
        by_jax = jmodels.ALSModel.load(str(tmp_path / "port"))
        by_port = pmodels.ALSModel.load(str(tmp_path / "jax"), device="cpu")
        again = pmodels.ALSModel.load(str(tmp_path / "port"), device="cpu")
        for idx in (by_jax.ann_index, by_port.ann_index, again.ann_index):
            assert idx is not None and idx.n_items == 4096
            for name, arr in port.ann_index.to_arrays().items():
                np.testing.assert_array_equal(idx.to_arrays()[name], arr)
        by_jax.configure_retrieval("ann")
        by_port.configure_retrieval("ann")
        for u in range(0, 32, 5):
            _same_answers(by_port.recommend(f"u{u}", 10), by_jax.recommend(f"u{u}", 10))

    def test_small_catalog_skips_the_index_in_both(self, tmp_path, jax_npz):
        port, jax_model = _models(n_items=512, seed=32)
        port.save(str(tmp_path / "port"))
        jax_model.save(str(tmp_path / "jax"))
        for d in ("port", "jax"):
            assert "ann" not in _meta(tmp_path / d)
            assert not (tmp_path / d / "ann").exists()
        assert pmodels.ALSModel.load(str(tmp_path / "port"), device="cpu").ann_index is None

    def test_env_switches_act_as_in_jax(self, tmp_path, jax_npz, monkeypatch):
        monkeypatch.setenv("PIO_SERVING_ANN_BUILD", "0")
        port, jax_model = _models(seed=33)
        port.save(str(tmp_path / "off-port"))
        jax_model.save(str(tmp_path / "off-jax"))
        assert port.ann_index is None and jax_model.ann_index is None
        assert _meta(tmp_path / "off-port") == _meta(tmp_path / "off-jax")
        monkeypatch.setenv("PIO_SERVING_ANN_BUILD", "1")
        monkeypatch.setenv("PIO_SERVING_ANN_NLIST", "16")
        port.save(str(tmp_path / "port"))
        jax_model.save(str(tmp_path / "jax"))
        assert port.ann_index.nlist == jax_model.ann_index.nlist == 16
        assert _meta(tmp_path / "port") == _meta(tmp_path / "jax")

    def test_torn_or_missing_payload_raises(self, tmp_path):
        port, _ = _models(seed=34)
        port.save(str(tmp_path))
        payload = next((tmp_path / "ann").glob("arrays-*.npz"))
        blob = bytearray(payload.read_bytes())
        blob[len(blob) // 2] ^= 0x20
        payload.write_bytes(bytes(blob))
        with pytest.raises(pckpt.CheckpointCorruptError):
            pmodels.ALSModel.load(str(tmp_path), device="cpu")
        payload.unlink()
        with pytest.raises(pckpt.CheckpointCorruptError):
            pmodels.ALSModel.load(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# quality
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quality_catalog():
    """(items, users, JAX index, port index) at 16,384 items, built once."""
    items = _factors(16384, seed=40)
    return (items, _factors(64, seed=41), *_both_indexes(items, seed=0))


class TestQuality:
    @pytest.mark.parametrize("nprobe,rescore", [(0, 0), (2, 0), (8, 0), (32, 0), (0, 200)])
    def test_quality_vs_brute_equals_jax(self, quality_catalog, nprobe, rescore):
        items, users, jidx, pidx = quality_catalog
        want = jann.quality_vs_brute(jidx, users, items, k=10, nprobe=nprobe,
                                     rescore=rescore)
        got = pann.quality_vs_brute(pidx, users, items, k=10, nprobe=nprobe,
                                    rescore=rescore, device="cpu")
        assert got == want

    def test_full_probe_recall_is_one(self):
        items = _factors(4096, seed=42)
        idx = pann.build_index(items)
        q = pann.quality_vs_brute(idx, _factors(32, seed=43), torch.from_numpy(items),
                                  nprobe=idx.nlist)
        assert q["recall_at_shortlist"] == 1.0 and q["map_at_k"] == 1.0


def test_brute_reference_agrees_between_packages():
    """The brute top-k both quality harnesses stand on."""
    items = _factors(2048, seed=50)
    users = _factors(8, seed=51)
    no_cols = np.zeros((8, 1), np.int32)
    no_mask = np.zeros((8, 1), np.float32)
    allow = np.ones((2048,), np.float32)
    want = jtopk.recommend_topk(jnp.asarray(users), jnp.asarray(items), jnp.asarray(no_cols),
                                jnp.asarray(no_mask), jnp.asarray(allow), 10)
    got = ptopk.recommend_topk(torch.from_numpy(users), torch.from_numpy(items),
                               torch.from_numpy(no_cols), torch.from_numpy(no_mask),
                               torch.from_numpy(allow), 10)
    _assert_same(got, want)


def test_a_batch_past_the_gather_cap_runs_in_row_chunks(monkeypatch):
    """Row chunks answer as the one vectorized call does."""
    items = _factors(4096, seed=60)
    users = _factors(20, seed=61)
    idx = pann.build_index(items)
    args = [torch.from_numpy(a) for a in _masks(20, 4096, "2d", seed=62)]
    qv, itf = torch.from_numpy(users), torch.from_numpy(items)
    whole = pann.ann_topk(qv, itf, *_port_args(idx), *args, 32, 8)
    sim = pann.ann_similar_topk(qv, itf, *_port_args(idx), *args, 32, 8)
    width = idx.shortlist_width(8)
    monkeypatch.setattr(pann, "_MAX_GATHER", 3 * width * K)
    assert pann._row_step(20, *_port_args(idx)[2:], 8, 0) == 3
    for got, want in ((pann.ann_topk(qv, itf, *_port_args(idx), *args, 32, 8), whole),
                      (pann.ann_similar_topk(qv, itf, *_port_args(idx), *args, 32, 8), sim)):
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
