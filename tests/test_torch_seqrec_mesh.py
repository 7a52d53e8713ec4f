"""The port's SeqRec training over a device mesh (``models/seqrec.py``
with ``mesh=``, the sessionrec template's ``use_mesh``) held against the
JAX package's on the CPU: JAX on the conftest's 8 CPU devices, the port
on ``["cpu"] * 8``, from JAX's own initial draw (``params_from_jax``) and
numpy-seeded sequences.

Tolerances are those of ``tests/test_torch_seqrec_train.py``: f32 loss
relative 1e-5, f32 gradients rtol 1e-5 / atol 1e-6, parameters after
Adam steps atol lr/100 (Adam moves a near-zero gradient's parameter by a
different fraction of lr in each framework). Over a "seq" axis the loss
is not tiled and attention is ring attention; over "data" and "model"
each position runs the single-device routes on its rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.models import seqrec as jseqrec
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.templates import sessionrec as jsess
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.parallel.mesh import Mesh, NamedSharding, ShardedArray, device_put
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import sessionrec
from predictionio_tpu_torch.workflow.context import EngineContext
from tests.test_torch_sessionrec_train import CYCLE, _cycle_events, _fill

MESHES = {
    "data4_seq2": {"data": 4, "seq": 2},
    "data8": {"data": 8},
    "data2_model4": {"data": 2, "model": 4},
    "data1_seq8": {"data": 1, "seq": 8},
}
FIELDS = dict(vocab=60, max_len=16, d_model=16, n_heads=2, n_layers=2)


def _meshes(axes: dict) -> tuple[JMesh, Mesh]:
    names, sizes = tuple(axes), tuple(axes.values())
    return (JMesh(np.asarray(jax.devices()[:8]).reshape(sizes), names),
            Mesh(np.array(["cpu"] * 8, dtype=object).reshape(sizes), names))


def _configs(**kw):
    fields = FIELDS | kw
    return (jseqrec.SeqRecConfig(dtype=jnp.float32, **fields),
            seqrec.SeqRecConfig(dtype=torch.float32, **fields))


def _sequences(seed=3, n=37, vocab=60):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, vocab, rng.integers(2, 30))] for _ in range(n)]


def _batch(cfg, seed: int, batch: int = 8):
    """Right-padded inputs and targets; the last row is all PAD."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(1, cfg.vocab, (batch, cfg.max_len))
    tgts = rng.integers(1, cfg.vocab, (batch, cfg.max_len))
    for i, n in enumerate(np.linspace(cfg.max_len, 0, batch).astype(int)):
        seqs[i, n:] = 0
        tgts[i, max(n - 1, 0):] = 0
    return seqs, tgts


def _as_port(tree) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in seqrec.params_from_jax(jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("name", MESHES)
class TestMeshVsJax:
    def test_loss_and_gradients(self, name):
        """One batch's loss and gradients through ``next_item_loss(mesh=)``."""
        jcfg, tcfg = _configs()
        jmesh, mesh = _meshes(MESHES[name])
        jparams = jseqrec.init_params(jax.random.PRNGKey(1), jcfg)
        seqs, tgts = _batch(tcfg, 2)
        want_loss, want_grads = jax.jit(jax.value_and_grad(jseqrec.next_item_loss),
                                        static_argnums=(3, 4))(
            jparams, jnp.asarray(seqs), jnp.asarray(tgts), jcfg, jmesh)
        model = seqrec.SeqRec(tcfg, "cpu")
        model.load_state_dict(seqrec.params_from_jax(jax.tree.map(np.asarray, jparams)))
        model.requires_grad_()
        loss = seqrec.next_item_loss(model, torch.from_numpy(seqs), torch.from_numpy(tgts),
                                     mesh=mesh)
        loss.backward()
        assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
        want = _as_port(want_grads)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=1e-5, atol=1e-6, err_msg=k)

    @pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
    def test_final_parameters(self, name, remat):
        """37 sequences at batch 16, three epochs in JAX's data order."""
        jcfg, tcfg = _configs(remat=remat)
        jmesh, mesh = _meshes(MESHES[name])
        seqs, lr = _sequences(), 3e-3
        want = _as_port(jseqrec.train(seqs, jcfg, epochs=3, batch_size=16, lr=lr, seed=5,
                                      mesh=jmesh))
        run = seqrec.train(seqs, tcfg, epochs=3, batch_size=16, lr=lr, seed=5, mesh=mesh,
                           initial=seqrec.params_from_jax(jax.tree.map(
                               np.asarray, jseqrec.init_params(jax.random.PRNGKey(5), jcfg))))
        assert len(run.losses) == 9 and all(np.isfinite(run.losses))
        for k, w in want.items():
            np.testing.assert_allclose(run.params[k].numpy(), w, atol=lr / 100, rtol=0, err_msg=k)


@pytest.mark.parametrize("batch_size,steps", [(16, 3), (6, 10), (2, 10)])
def test_batch_rounds_to_the_data_axis(batch_size, steps):
    """JAX's ``bs = max(mult, (bs // mult) * mult)`` with mult = 4: 16
    stays, 6 and 2 become 4 (37 sequences: 3 or 10 steps an epoch); the
    parameters equal JAX's."""
    jcfg, tcfg = _configs()
    jmesh, mesh = _meshes(MESHES["data4_seq2"])
    seqs, lr = _sequences(), 3e-3
    want = _as_port(jseqrec.train(seqs, jcfg, epochs=1, batch_size=batch_size, lr=lr, seed=5,
                                  mesh=jmesh))
    run = seqrec.train(seqs, tcfg, epochs=1, batch_size=batch_size, lr=lr, seed=5, mesh=mesh,
                       initial=seqrec.params_from_jax(jax.tree.map(
                           np.asarray, jseqrec.init_params(jax.random.PRNGKey(5), jcfg))))
    assert len(run.losses) == steps
    for k, w in want.items():
        np.testing.assert_allclose(run.params[k].numpy(), w, atol=lr / 100, rtol=0, err_msg=k)


def test_model_axis_repeats_no_work():
    """Over {"data": 2, "model": 4} on one device the forward runs once per
    data shard: the four positions along "model" share one tensor."""
    _, tcfg = _configs()
    _, mesh = _meshes(MESHES["data2_model4"])
    model = seqrec.SeqRec(tcfg, "cpu")
    model.load_state_dict(seqrec.init_params(tcfg, torch.Generator().manual_seed(0)))
    seqs, _ = _batch(tcfg, 3)
    h = seqrec.forward_mesh(model, device_put(torch.from_numpy(seqs),
                                              NamedSharding(mesh, seqrec.batch_spec(mesh))), mesh)
    assert isinstance(h, ShardedArray) and len({id(s) for s in h.shards}) == 2
    with torch.no_grad():
        whole = model(torch.from_numpy(seqs), inference=False)
    torch.testing.assert_close(h.gather(), whole, rtol=1e-6, atol=1e-6)


def test_forward_over_seq_equals_the_whole_sequence():
    """The ring route's hidden states (position embeddings offset per
    block) equal the single-device forward."""
    _, tcfg = _configs()
    _, mesh = _meshes(MESHES["data4_seq2"])
    model = seqrec.SeqRec(tcfg, "cpu")
    model.load_state_dict(seqrec.init_params(tcfg, torch.Generator().manual_seed(1)))
    seqs, _ = _batch(tcfg, 4)
    with torch.no_grad():
        h = seqrec.forward_mesh(model, device_put(torch.from_numpy(seqs), NamedSharding(
            mesh, ("data", "seq"))), mesh)
        want = model(torch.from_numpy(seqs), seqrec.blockwise_attention, inference=False)
    torch.testing.assert_close(h.gather(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the sessionrec template (tests/test_sessionrec_template.py:133-172)
# ---------------------------------------------------------------------------


@pytest.fixture
def stores():
    events = _cycle_events()
    return (_fill(memory_storage(), App, Event, events),
            _fill(jax_memory_storage(), JaxApp, JaxEvent, events))


def _port_ctx(storage, **axes):
    return EngineContext(storage=storage, device="cpu", devices=["cpu"] * 8).with_axes(**axes)


def test_seq_mesh_training(stores):
    """JAX's test_seq_mesh_training on both packages: train over a
    {data: 4, seq: 2} mesh (remat on), then predict."""
    port_storage, jax_storage = stores
    params = dict(d_model=32, n_layers=1, n_heads=2, max_len=16, epochs=2, batch_size=16,
                  remat=True)
    jctx = JaxEngineContext(storage=jax_storage).with_axes(data=4, seq=2)
    jtd = jsess.SessionDataSource(jsess.DataSourceParams(app_name="SessApp")).read_training(jctx)
    jalgo = jsess.SeqRecAlgorithm(jsess.AlgorithmParams(**params))
    jmodel = jalgo.train(jctx, jtd)
    assert jmodel.params["item_emb"].shape[0] == CYCLE + 1
    assert len(jalgo.predict(jmodel, jsess.Query(items=("i1", "i2"), num=2)).item_scores) == 2

    ctx = _port_ctx(port_storage, data=4, seq=2)
    assert ctx.mesh.shape == {"data": 4, "seq": 2} and ctx.mesh_if_parallel is ctx.mesh
    td = sessionrec.SessionDataSource(
        sessionrec.DataSourceParams(app_name="SessApp")).read_training(ctx)
    algo = sessionrec.SeqRecAlgorithm(sessionrec.AlgorithmParams(**params))
    model = algo.train(ctx, td)
    assert model.params["item_emb"].shape[0] == CYCLE + 1
    r = algo.predict(model, sessionrec.Query(items=("i1", "i2"), num=2))
    assert len(r.item_scores) == 2
    # two epochs of batch-16 steps, every one over the mesh
    assert len(model.train_run.losses) == 2 * -(-len(td.sequences) // 16)
    assert all(np.isfinite(model.train_run.losses))


def test_use_mesh_false_trains_unsharded(stores, monkeypatch):
    """``use_mesh=False`` trains without the mesh, even over 8 devices."""
    port_storage, _ = stores
    seen = []
    real = seqrec.train
    monkeypatch.setattr(seqrec, "train", lambda *a, **kw: seen.append(kw["mesh"]) or real(*a, **kw))
    ctx = _port_ctx(port_storage, data=4, seq=2)
    td = sessionrec.SessionDataSource(
        sessionrec.DataSourceParams(app_name="SessApp")).read_training(ctx)
    for use_mesh in (True, False):
        sessionrec.SeqRecAlgorithm(sessionrec.AlgorithmParams(
            d_model=16, n_layers=1, max_len=16, epochs=1, use_mesh=use_mesh)).train(ctx, td)
    assert seen == [ctx.mesh, None]


def test_max_len_must_match_seq_axis(stores):
    """JAX's test_max_len_must_match_seq_axis: the same ValueError text."""
    port_storage, jax_storage = stores
    messages = []
    for ctx, mod in ((JaxEngineContext(storage=jax_storage).with_axes(data=2, seq=3), jsess),
                     (_port_ctx(port_storage, data=2, seq=3), sessionrec)):
        td = mod.SessionDataSource(mod.DataSourceParams(app_name="SessApp")).read_training(ctx)
        algo = mod.SeqRecAlgorithm(mod.AlgorithmParams(max_len=16, epochs=1))
        with pytest.raises(ValueError, match="multiple of the seq") as err:
            algo.train(ctx, td)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_context_builds_a_seq_mesh():
    ctx = EngineContext(device="cpu", devices=["cpu"] * 8).with_axes(data=4, seq=2)
    mesh = ctx.mesh
    assert mesh.shape == {"data": 4, "seq": 2} and mesh.size == 8
    assert not mesh.multiprocess and mesh.local_positions == mesh.positions
    assert ctx.device_ranks == [0] * 8


DISTINCT = {"data2_model2": {"data": 2, "model": 2},
            "data2_seq2_model2": {"data": 2, "seq": 2, "model": 2}}


@pytest.mark.parametrize("name", DISTINCT)
def test_model_axis_over_distinct_devices(name):
    """Every position on a device object of its own (``cpu:i``), as on
    distinct cards: the positions at "model" index 0 run, one replica
    each, and the others do no work. The loss, the gradients and three
    epochs of training equal JAX's on the same mesh."""
    axes = DISTINCT[name]
    names, sizes = tuple(axes), tuple(axes.values())
    jmesh = JMesh(np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), names)
    grid = np.array([f"cpu:{i}" for i in range(int(np.prod(sizes)))], dtype=object)
    mesh = Mesh(grid.reshape(sizes), names)
    sub = seqrec.batch_mesh(mesh)
    assert sub.shape == {a: n for a, n in axes.items() if a != "model"}
    jcfg, tcfg = _configs()
    jparams = jseqrec.init_params(jax.random.PRNGKey(1), jcfg)
    model = seqrec.SeqRec(tcfg, "cpu")
    model.load_state_dict(seqrec.params_from_jax(jax.tree.map(np.asarray, jparams)))
    assert len(seqrec.replicas(model, sub)) == sub.size
    seqs, tgts = _batch(tcfg, 2)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jseqrec.next_item_loss),
                                    static_argnums=(3, 4))(
        jparams, jnp.asarray(seqs), jnp.asarray(tgts), jcfg, jmesh)
    step = seqrec.make_train_step(model, mesh=mesh)
    opt_m, opt_v = seqrec.adam_state(model)
    loss = step(opt_m, opt_v, 1, torch.from_numpy(seqs), torch.from_numpy(tgts), 0.0)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = _as_port(want_grads)
    # lr 0: the step leaves the parameters; Adam's first moment is 0.1·g
    for k, m in zip(dict(model.named_parameters()), opt_m):
        np.testing.assert_allclose(m.numpy() / 0.1, want[k], rtol=1e-5, atol=1e-5, err_msg=k)

    seqs, lr = _sequences(), 3e-3
    want = _as_port(jseqrec.train(seqs, jcfg, epochs=3, batch_size=16, lr=lr, seed=5,
                                  mesh=jmesh))
    run = seqrec.train(seqs, tcfg, epochs=3, batch_size=16, lr=lr, seed=5, mesh=mesh,
                       initial=seqrec.params_from_jax(jax.tree.map(
                           np.asarray, jseqrec.init_params(jax.random.PRNGKey(5), jcfg))))
    assert len(run.losses) == 9 and all(np.isfinite(run.losses))
    for k, w in want.items():
        np.testing.assert_allclose(run.params[k].numpy(), w, atol=lr / 100, rtol=0, err_msg=k)
