"""The mesh layer and DP×MP ALS in the port, held against JAX's 8-device
CPU mesh: ``parallel/mesh.py`` (padding, placement, the collectives),
``workflow/context.py``'s mesh and ``meshConf``, and ``ops/als.py`` over
a mesh (the twins of tests/test_als.py's ``test_sharded_*`` and
``test_fused_tp_*``). The port's meshes lay their positions over
``["cpu"] * n``.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from predictionio_tpu.ops import als as jals
from predictionio_tpu.parallel import mesh as jmesh
from predictionio_tpu.workflow import context as jctx
from predictionio_tpu.workflow import engine_json as jej
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.parallel import mesh as pmesh
from predictionio_tpu_torch.parallel.mesh import Mesh, ShardedArray
from predictionio_tpu_torch.workflow import context as pctx
from predictionio_tpu_torch.workflow import engine_json as pej

pytestmark = pytest.mark.mesh

#: f32 factors, sharded against replicated and against JAX's
FACTOR_TOL = 2e-4
#: JAX's own sharded-vs-single tolerance (tests/test_als.py:278)
SINGLE_TOL = 1e-4


def port_mesh(shape, n=8) -> Mesh:
    return Mesh(np.asarray(["cpu"] * n, dtype=object).reshape(shape), ("data", "model"))


@pytest.fixture
def jax_mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8-device CPU topology")
    return JaxMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))


def jax_item0(seed, num_items, rank):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (num_items, rank),
                                        dtype=jnp.float32) / jnp.sqrt(jnp.float32(rank)))


def _coo(seed, users, items, nnz, skew=1.0, scale=5.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return ((users * rng.random(nnz) ** skew).astype(np.int32),
            (items * rng.random(nnz) ** skew).astype(np.int32),
            (rng.random(nnz) * scale + offset).astype(np.float32), users, items)


class TestMeshPrimitives:
    @pytest.mark.parametrize("n, multiple", [(0, 4), (5, 4), (8, 4), (7, 1)])
    def test_pad_to_multiple_equals_jax(self, n, multiple):
        a = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        got, want = pmesh.pad_to_multiple(a, multiple, fill=-1), \
            jmesh.pad_to_multiple(a, multiple, fill=-1)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]

    def test_shard_batch_pads_and_splits_as_jax(self, jax_mesh8):
        mesh = port_mesh((4, 2))
        a = np.arange(10, dtype=np.int32)
        (got,), n = pmesh.shard_batch([a], mesh, fill=7)
        (want,), wn = jmesh.shard_batch([a], jax_mesh8, fill=7)
        assert n == wn == 10 and got.shape == want.shape == (12,)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        # each position holds its data shard, the same along "model"
        for pos in mesh.positions:
            d = pmesh.axis_index(mesh, pos, "data")
            np.testing.assert_array_equal(got.local(pos).numpy(), np.asarray(want)[3 * d:3 * d + 3])
        assert got.local((1, 0)) is got.local((1, 1))   # one device: one tensor

    def test_device_put_needs_an_even_split(self):
        with pytest.raises(ValueError, match="does not divide"):
            pmesh.device_put(np.zeros((7, 2)), pmesh.model_sharding(port_mesh((4, 2))))

    def test_collectives(self):
        mesh = port_mesh((2, 4))
        x = torch.arange(24.0).reshape(8, 3)
        s = pmesh.device_put(x, pmesh.model_sharding(mesh))
        assert s.shape == (8, 3) and s.local((1, 3)).shape == (2, 3)
        assert torch.equal(s.gather(), x)
        assert torch.equal(pmesh.all_gather(s, "model").local((1, 2)), x)
        assert torch.equal(s.rows([7, 0, 3]), x[[7, 0, 3]]) and torch.equal(s[5], x[5])
        head = s.head(5)
        assert head.shape == (5, 3) and torch.equal(head.gather(), x[:5])
        assert [head.local((0, m)).shape[0] for m in range(4)] == [2, 2, 1, 0]
        part = ShardedArray.from_local(mesh, (), lambda p: torch.tensor([float(p[0]), p[1]]))
        assert torch.equal(pmesh.psum(part, "data").local((0, 3)), torch.tensor([1.0, 6.0]))
        assert torch.equal(pmesh.psum(part, ("data", "model")).local((1, 1)),
                           torch.tensor([4.0, 12.0]))
        assert [pmesh.axis_index(mesh, (1, 2), a) for a in ("data", "model", "seq")] == [1, 2, 0]


class TestContextMesh:
    def test_factor_mesh_equals_jax(self):
        for n in range(1, 33):
            assert pctx._factor_mesh(n) == jctx._factor_mesh(n), n

    def test_mesh_from_conf_and_the_device_error(self):
        wp = pctx.WorkflowParams(mesh_conf={"axes": {"data": 2, "model": 2}})
        ctx = pctx.EngineContext(wp, device="cpu", devices=["cpu"] * 4)
        assert ctx.mesh.shape == {"data": 2, "model": 2} and ctx.num_devices == 4
        assert ctx.mesh_if_parallel is ctx.mesh
        assert pctx.EngineContext(device="cpu", devices=["cpu"] * 8).mesh.shape == \
            {"data": 4, "model": 2}
        assert pctx.EngineContext(device="cpu").mesh_if_parallel is None   # one device
        big = ctx.with_axes(data=4, model=2)
        with pytest.raises(ValueError) as got:
            big.mesh
        with pytest.raises(ValueError) as want:
            jctx.EngineContext(jctx.WorkflowParams(mesh_conf={"axes": {"data": 4, "model": 2}}),
                               devices=jax.devices()[:4]).mesh
        assert str(got.value) == str(want.value)

    def test_one_position_is_no_mesh(self):
        wp = pctx.WorkflowParams(mesh_conf={"axes": {"data": 1, "model": 1}})
        assert pctx.EngineContext(wp, device="cpu", devices=["cpu"] * 2).mesh_if_parallel is None

    def test_mesh_conf_from_variant_equals_jax(self, caplog):
        for variant in ({}, {"meshConf": {"axes": {"data": 4, "model": 2}}},
                        {"sparkConf": {"spark.executor.memory": "4g"}}):
            assert pej.mesh_conf_from_variant(variant) == jej.mesh_conf_from_variant(variant)
        with caplog.at_level(logging.WARNING):
            pej.mesh_conf_from_variant({"sparkConf": {}})
        assert "'sparkConf' subtree" in caplog.text and "meshConf" in caplog.text


class TestShardedTraining:
    @pytest.mark.parametrize("layout", ["chunked", "bucketed", "fused"])
    def test_sharded_matches_single_device(self, jax_mesh8, layout):
        """A mesh without factor sharding: the port's run equals its own
        single-device run, and in f32 from JAX's draw JAX's sharded run."""
        coo = _coo(3, 32, 16, 400)
        kw = dict(rank=4, iterations=3, lam=0.05, seed=1, layout=layout)
        single = pals.als_train(pals.RatingsCOO(*coo), device="cpu", **kw)
        sharded = pals.als_train(pals.RatingsCOO(*coo), mesh=port_mesh((4, 2)), **kw)
        np.testing.assert_allclose(single.user.numpy(), sharded.user.numpy(), rtol=SINGLE_TOL,
                                   atol=SINGLE_TOL)
        kw["matmul_dtype"] = "float32"
        got = pals.als_train(pals.RatingsCOO(*coo), mesh=port_mesh((4, 2)),
                             item0=jax_item0(1, 16, 4), **kw)
        want = jals.als_train(jals.RatingsCOO(*coo), mesh=jax_mesh8, **kw)
        for side in ("user", "item"):
            np.testing.assert_allclose(getattr(got, side).numpy(),
                                       np.asarray(getattr(want, side)), rtol=FACTOR_TOL,
                                       atol=FACTOR_TOL)

    def test_sharded_factor_table_matches_replicated(self, jax_mesh8):
        """solve_half with V row-sharded over "model" equals V replicated,
        and JAX's tensor-parallel half-step."""
        rng = np.random.default_rng(5)
        coo = (64 * rng.random(8_000)).astype(np.int32), \
            (48 * rng.random(8_000)).astype(np.int32), \
            rng.random(8_000).astype(np.float32) * 5, 64, 48
        V = rng.standard_normal((48, 8)).astype(np.float32)
        mesh = port_mesh((4, 2))
        b = pals.bucket_rows(pals.RatingsCOO(*coo), min_len=8)
        rep = pals.solve_half(torch.from_numpy(V), b, 8, 0.05, mesh=mesh)
        tp = pals.solve_half(torch.from_numpy(V), b, 8, 0.05, mesh=mesh, shard_factors=True)
        np.testing.assert_allclose(rep.numpy(), tp.numpy(), atol=1e-5)
        want = jals.solve_half(jnp.asarray(V), jals.bucket_rows(jals.RatingsCOO(*coo), min_len=8),
                               8, 0.05, mesh=jax_mesh8, shard_factors=True)
        np.testing.assert_allclose(tp.numpy(), np.asarray(want), rtol=FACTOR_TOL,
                                   atol=FACTOR_TOL)

    def test_fused_tp_factor_tables_are_model_sharded(self, jax_mesh8):
        coo = _coo(9, 96, 64, 12_000, skew=1.6)
        kw = dict(rank=8, iterations=3, lam=0.05, seed=1, layout="fused",
                  matmul_dtype="float32")
        item0 = jax_item0(1, 64, 8)
        single = pals.als_train(pals.RatingsCOO(*coo), item0=item0, device="cpu", **kw)
        tp = pals.als_train(pals.RatingsCOO(*coo), item0=item0, mesh=port_mesh((4, 2)),
                            shard_factors=True, **kw)
        want = jals.als_train(jals.RatingsCOO(*coo), mesh=jax_mesh8, shard_factors=True, **kw)
        for side, n in (("user", 96), ("item", 64)):
            table = getattr(tp, side)
            np.testing.assert_array_equal(np.asarray(table), getattr(single, side).numpy())
            np.testing.assert_allclose(np.asarray(table), np.asarray(getattr(want, side)),
                                       rtol=FACTOR_TOL, atol=FACTOR_TOL)
            assert table.spec[0] == "model"
            assert {table.local(p).shape[0] for p in table.mesh.positions} == {n // 2}

    @pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
    def test_fused_tp_handles_nondivisible_rows_and_implicit(self, jax_mesh8, implicit):
        """91 users and 53 items pad to the model axis and are trimmed;
        the implicit gramian ignores the pad rows."""
        coo = _coo(11, 91, 53, 6_000, skew=1.6, scale=4.0, offset=1.0)
        kw = dict(rank=4, iterations=2, lam=0.05, seed=2, implicit=implicit, alpha=8.0,
                  layout="fused", matmul_dtype="float32")
        item0 = jax_item0(2, 53, 4)
        single = pals.als_train(pals.RatingsCOO(*coo), item0=item0, device="cpu", **kw)
        tp = pals.als_train(pals.RatingsCOO(*coo), item0=item0, mesh=port_mesh((4, 2)),
                            shard_factors=True, **kw)
        want = jals.als_train(jals.RatingsCOO(*coo), mesh=jax_mesh8, shard_factors=True, **kw)
        assert tuple(tp.user.shape) == (91, 4) and tuple(tp.item.shape) == (53, 4)
        for side in ("user", "item"):
            got = np.asarray(getattr(tp, side))
            np.testing.assert_allclose(got, getattr(single, side).numpy(), rtol=FACTOR_TOL,
                                       atol=FACTOR_TOL)
            np.testing.assert_allclose(got, np.asarray(getattr(want, side)), rtol=FACTOR_TOL,
                                       atol=FACTOR_TOL)

    def test_chunked_tp_on_two_by_two(self):
        """The chunked layout with the opposite table sharded over a 2×2
        mesh: the accumulators sum over the mesh (another order of the
        additions), so within tolerance of the single-device run."""
        coo = pals.RatingsCOO(*_coo(4, 120, 80, 3_000, skew=1.6))
        kw = dict(rank=4, iterations=2, lam=0.05, seed=0, layout="chunked",
                  chunk_sizes=(16, 4), matmul_dtype="float32")
        single = pals.als_train(coo, device="cpu", **kw)
        tp = pals.als_train(coo, mesh=port_mesh((2, 2), 4), shard_factors=True, **kw)
        for side in ("user", "item"):
            np.testing.assert_allclose(getattr(tp, side).numpy(),
                                       getattr(single, side).numpy(), rtol=FACTOR_TOL,
                                       atol=FACTOR_TOL)

    def test_streamed_buckets_over_a_mesh(self):
        coo = pals.RatingsCOO(*_coo(6, 50, 30, 1_500, skew=1.6))
        kw = dict(rank=4, iterations=2, lam=0.05, seed=0, layout="bucketed",
                  hbm_resident=False, matmul_dtype="float32")
        single = pals.als_train(coo, device="cpu", **kw)
        got = pals.als_train(coo, mesh=port_mesh((2, 4)), **kw)
        assert torch.equal(got.user, single.user) and torch.equal(got.item, single.item)
