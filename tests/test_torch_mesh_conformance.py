"""The port's in-process mesh on every shape an operator can deploy over
8 devices, 1×8, 2×4 and 4×2, held against JAX's 8-device CPU mesh of the
same shape (the twin of tests/test_mesh_conformance.py, case for case):

- kernel: ``recommend_topk_sharded`` equals the flat dispatch, and JAX's
  sharded top-k on the same mesh (values 1e-6, indices equal where the
  score is finite), with k above a shard's rows, a batch that does not
  divide "data", k above the catalog, and ties;
- train: fused ``shard_factors=True`` equals the replicated run, and
  JAX's sharded run from JAX's draw (f32, 2e-4);
- serving: a saved sharded model restores sharded and serves what the
  replicated brute dispatch serves; the ``PIO_*_SHARD_FACTORS`` knobs;
- process: this file run as a script is a fresh process driven by
  ``PIO_TRAIN_SHARD_FACTORS=1`` alone (the twin of
  tests/mesh_parity_child.py).

The port's meshes lay 8 positions over ``["cpu"] * 8``.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.ops import topk as ptopk
from predictionio_tpu_torch.parallel.mesh import Mesh, ShardedArray
from predictionio_tpu_torch.utils.bimap import BiMap, EntityIdIxMap

pytestmark = pytest.mark.mesh

MESH_SHAPES = ((1, 8), (2, 4), (4, 2))
SHAPE_IDS = [f"{d}x{m}" for d, m in MESH_SHAPES]
TOPK_TOL = 1e-6      # values; indices equal where the score is finite
FACTOR_TOL = 2e-4    # f32 factors, sharded against replicated and against JAX
SCORE_TOL = 1e-5     # served scores, sharded against brute


def port_mesh(shape) -> Mesh:
    return Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(shape), ("data", "model"))


def jax_mesh(shape):
    import jax
    from jax.sharding import Mesh as JaxMesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8-device CPU topology")
    return JaxMesh(np.asarray(jax.devices()[:8]).reshape(shape), ("data", "model"))


def _setup(B, I, K=8, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, K)).astype(np.float32),
            rng.standard_normal((I, K)).astype(np.float32),
            rng.integers(0, I, (B, S)).astype(np.int32),
            (rng.random((B, S)) < 0.5).astype(np.float32),
            (rng.random(I) < 0.9).astype(np.float32))


def _port(args):
    uv, itf, cols, mask, allow = args
    return (torch.from_numpy(uv), torch.from_numpy(itf), torch.from_numpy(cols).long(),
            torch.from_numpy(mask), torch.from_numpy(allow))


def _assert_topk_equal(got, want):
    v, i = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(v, wv, rtol=TOPK_TOL, atol=TOPK_TOL)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(v), finite)
    np.testing.assert_array_equal(i[finite], wi[finite])


def _both(shape, args, k):
    """The port's sharded top-k against its flat dispatch and against
    JAX's sharded top-k on the same mesh shape."""
    import jax.numpy as jnp

    from predictionio_tpu.ops.topk import recommend_topk_sharded as jax_sharded

    got = ptopk.recommend_topk_sharded(*_port(args), k, port_mesh(shape))
    _assert_topk_equal(got, ptopk.recommend_topk(*_port(args), k))
    _assert_topk_equal(got, jax_sharded(*(jnp.asarray(a) for a in args), k, jax_mesh(shape)))
    return got


class TestShardedTopkEveryMeshShape:
    @pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
    def test_matches_flat_dispatch(self, shape):
        _both(shape, _setup(8, 64), 5)

    @pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
    def test_k_exceeding_shard_rows(self, shape):
        """On 1×8 a 64-item catalog has 8-row shards: the local top-k
        clamps to them and the merge recovers the global top-20."""
        _both(shape, _setup(8, 64, seed=2), 20)

    @pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
    @pytest.mark.parametrize("B", (1, 3))
    def test_batch_not_dividing_data_axis(self, shape, B):
        vals, _ = _both(shape, _setup(B, 64, seed=4), 5)
        assert vals.shape == (B, 5)

    def test_k_larger_than_catalog_clamps(self):
        vals, idxs = _both((1, 8), _setup(4, 16, seed=5), 300)
        assert vals.shape == (4, 16) and idxs.dtype == torch.int64

    @pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
    def test_ties_keep_the_lower_index_first(self, shape):
        """Equal scores across shards: the merge keeps the lower global
        index first, as the flat path and lax.top_k do."""
        I = 64
        items = np.ones((I, 2), np.float32)
        items[::3] = 2.0
        items[5] = 0.0
        args = (np.ones((3, 2), np.float32), items, np.zeros((3, 2), np.int32),
                np.asarray([[1, 0], [0, 0], [1, 1]], np.float32), np.ones(I, np.float32))
        vals, idxs = _both(shape, args, 30)
        assert idxs[1, :5].tolist() == [0, 3, 6, 9, 12]

    def test_catalog_not_dividing_the_model_axis_raises(self):
        with pytest.raises(ValueError, match="must divide the model axis"):
            ptopk.recommend_topk_sharded(*_port(_setup(4, 60)), 5, port_mesh((1, 8)))


def _skewed_coo(seed, users, items, nnz, scale=5.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return ((users * rng.random(nnz) ** 1.6).astype(np.int32),
            (items * rng.random(nnz) ** 1.6).astype(np.int32),
            (rng.random(nnz) * scale + offset).astype(np.float32), users, items)


def jax_item0(seed, num_items, rank):
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (num_items, rank),
                                        dtype=jnp.float32) / jnp.sqrt(jnp.float32(rank)))


class TestShardedTrainEveryMeshShape:
    @pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
    def test_fused_sharded_matches_replicated(self, shape):
        """Fused DP×MP factors equal the replicated ones (to the last bit:
        a whole row is built and solved at one position) and JAX's sharded
        factors from JAX's draw; both tables row-sharded over "model"."""
        from predictionio_tpu.ops import als as jals

        coo = _skewed_coo(13, 64, 48, 6_000)
        kw = dict(rank=8, iterations=2, lam=0.05, seed=1, layout="fused",
                  matmul_dtype="float32")
        item0 = jax_item0(1, 48, 8)
        rep = pals.als_train(pals.RatingsCOO(*coo), item0=item0, device="cpu", **kw)
        tp = pals.als_train(pals.RatingsCOO(*coo), item0=item0, mesh=port_mesh(shape),
                            shard_factors=True, **kw)
        want = jals.als_train(jals.RatingsCOO(*coo), mesh=jax_mesh(shape), shard_factors=True,
                              **kw)
        for side in ("user", "item"):
            got = np.asarray(getattr(tp, side))
            np.testing.assert_array_equal(got, getattr(rep, side).numpy())
            np.testing.assert_allclose(got, np.asarray(getattr(want, side)), rtol=FACTOR_TOL,
                                       atol=FACTOR_TOL)
            table = getattr(tp, side)
            assert isinstance(table, ShardedArray) and table.spec[0] == "model"
            assert table.ways("model") == shape[1]


def _model(U=40, I=64, K=8, seed=21) -> ALSModel:
    rng = np.random.default_rng(seed)
    return ALSModel(
        rank=K, user_factors=torch.from_numpy(rng.standard_normal((U, K)).astype(np.float32)),
        item_factors=torch.from_numpy(rng.standard_normal((I, K)).astype(np.float32)),
        user_ids=EntityIdIxMap(BiMap({f"u{i}": i for i in range(U)})),
        item_ids=EntityIdIxMap(BiMap({f"i{i}": i for i in range(I)})),
        seen_by_user={0: np.asarray([1, 2, 3], dtype=np.int32)})


def _serves_equal(sharded: ALSModel, brute: ALSModel, users=("u0", "u5", "u11")) -> None:
    for uid in users:
        a, b = brute.recommend(uid, 10), sharded.recommend(uid, 10)
        assert [x[0] for x in a] == [x[0] for x in b]
        np.testing.assert_allclose([x[1] for x in a], [x[1] for x in b], atol=SCORE_TOL)
    uixs = np.asarray([brute.user_ids[u] for u in users], dtype=np.int32)
    cols = np.zeros((len(users), 512), dtype=np.int32)
    mask = np.zeros((len(users), 512), dtype=np.float32)
    cols[0, :3] = [1, 2, 3]
    mask[0, :3] = 1.0
    va, ia = brute.batch_topk(uixs, cols, mask, None, 12)
    vb, ib = sharded.batch_topk(uixs, cols, mask, None, 12)
    np.testing.assert_array_equal(ia.numpy(), ib.numpy())
    np.testing.assert_allclose(va.numpy(), vb.numpy(), atol=SCORE_TOL)


class TestServingDispatch:
    def test_sharded_model_serves_equal_to_brute(self, tmp_path, monkeypatch):
        """save() then load() under PIO_SERVING_SHARD_FACTORS=1 restores
        row-sharded over the 8 devices, =0 replicated; recommend() and
        batch_topk() agree."""
        monkeypatch.setenv("PIO_SERVING_ANN_BUILD", "0")
        d = str(tmp_path / "model")
        _model().save(d)
        monkeypatch.setenv("PIO_SERVING_SHARD_FACTORS", "1")
        sharded = ALSModel.load(d, "cpu", devices=["cpu"] * 8)
        monkeypatch.setenv("PIO_SERVING_SHARD_FACTORS", "0")
        brute = ALSModel.load(d, "cpu", devices=["cpu"] * 8)
        assert sharded.factor_shard_ways == 8
        assert brute.factor_shard_ways == 1
        _serves_equal(sharded, brute)

    def test_env_resolution(self, monkeypatch):
        monkeypatch.delenv("PIO_TRAIN_SHARD_FACTORS", raising=False)
        assert pals.resolve_shard_factors(True) is True
        assert pals.resolve_shard_factors(False) is False
        monkeypatch.setenv("PIO_TRAIN_SHARD_FACTORS", "1")
        assert pals.resolve_shard_factors(False) is True
        monkeypatch.setenv("PIO_TRAIN_SHARD_FACTORS", "off")
        assert pals.resolve_shard_factors(True) is False

    def test_one_device_stays_replicated_and_says_so(self, tmp_path, monkeypatch, caplog):
        """A model persisted sharded, loaded where one device is
        available, serves replicated with a warning (JAX on one TPU)."""
        monkeypatch.setenv("PIO_SERVING_ANN_BUILD", "0")
        monkeypatch.delenv("PIO_SERVING_SHARD_FACTORS", raising=False)
        d = str(tmp_path / "model")
        _model().save(d)
        sharded = ALSModel.load(d, "cpu", mesh=Mesh(np.asarray(["cpu"] * 4, dtype=object)
                                                     .reshape(1, 4), ("data", "model")))
        sharded.save(d)
        assert sharded.factor_shard_ways == 4
        with caplog.at_level("WARNING"):
            assert ALSModel.load(d, "cpu").factor_shard_ways == 1
        assert "serving replicated" in caplog.text


class TestMeshChild:
    def test_forced_8_device_child_pins_parity_and_serving(self, run_mesh_child):
        """This file as a fresh process, sharding turned on by the env
        knob alone: train parity on every shape, then save → auto-sharded
        load → sharded serving equal to brute."""
        code, out, err = run_mesh_child(os.path.basename(__file__),
                                        env={"PIO_TRAIN_SHARD_FACTORS": "1"})
        assert code == 0, f"child failed\nstdout:\n{out}\nstderr:\n{err}"
        assert "MESH PARITY OK" in out, out
        for shape in SHAPE_IDS:
            assert f"parity {shape}: OK" in out, out


def _child() -> None:
    """The fresh-process run (``python tests/test_torch_mesh_conformance.py``
    with ``PIO_TRAIN_SHARD_FACTORS=1``): the port only, no JAX."""
    assert os.environ.get("PIO_TRAIN_SHARD_FACTORS") == "1"
    assert pals.resolve_shard_factors(False) is True
    coo = pals.RatingsCOO(*_skewed_coo(7, 96, 64, 10_000))
    kw = dict(rank=8, iterations=3, lam=0.05, seed=3, layout="fused", matmul_dtype="float32")
    replicated = pals.als_train(coo, device="cpu", **kw)
    for shape in MESH_SHAPES:
        sharded = pals.als_train(coo, mesh=port_mesh(shape),
                                 shard_factors=pals.resolve_shard_factors(False), **kw)
        for side in ("user", "item"):
            np.testing.assert_allclose(np.asarray(getattr(sharded, side)),
                                       getattr(replicated, side).numpy(), rtol=FACTOR_TOL,
                                       atol=FACTOR_TOL)
        assert sharded.item.spec[0] == "model", sharded.item.spec
        print(f"parity {shape[0]}x{shape[1]}: OK")
    factors = pals.als_train(coo, mesh=port_mesh((2, 4)),
                             shard_factors=pals.resolve_shard_factors(False), **kw)
    model = ALSModel(rank=8, user_factors=factors.user, item_factors=factors.item,
                     user_ids=EntityIdIxMap(BiMap({f"u{i}": i for i in range(96)})),
                     item_ids=EntityIdIxMap(BiMap({f"i{i}": i for i in range(64)})),
                     seen_by_user={0: np.asarray([1, 2, 3], dtype=np.int32)})
    assert model.factor_shard_ways == 4
    os.environ["PIO_SERVING_ANN_BUILD"] = "0"
    with tempfile.TemporaryDirectory() as d:
        model.save(d)
        loaded = ALSModel.load(d, "cpu", devices=["cpu"] * 8)   # resharded from the meta
        assert loaded.factor_shard_ways > 1, loaded.factor_shard_ways
        os.environ["PIO_SERVING_SHARD_FACTORS"] = "0"
        brute = ALSModel.load(d, "cpu", devices=["cpu"] * 8)    # the env veto
        assert brute.factor_shard_ways == 1
    _serves_equal(loaded, brute, ("u0", "u7", "u41"))
    print("serving equality: OK")
    print("MESH PARITY OK")


if __name__ == "__main__":
    sys.exit(_child())
