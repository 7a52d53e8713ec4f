"""The port's multi-process mesh (``parallel/distributed.py`` and the
cross-process collectives of ``parallel/mesh.py``) held against JAX's
``tests/test_distributed_multihost.py`` on the CPU.

Each test starts two processes of this file (``python <file> <child>``)
with the PIO_* env contract; each is one gloo rank holding two CPU mesh
positions, so a 4-position global mesh spans both, as JAX's children lay
out two forced CPU devices a process. The children run the port only
(no JAX); they write their results to a directory the test reads.
Tolerances:

- ALS tables: to the per-row float64 oracle at JAX's 2e-3; to JAX's
  single-process 4-device run of the same program at 1e-5 (absolute,
  tables of magnitude ~1: f32 CG in another summation order); to the
  port's in-process mesh at 1e-6 (the same solves: a cross-process sum
  adds each rank's partial sum, one reassociation a group, and the
  write-back's rows come from one data shard each).
- Ring attention (forward and gradients) and two Adam steps of seqrec:
  to the same program on an in-process mesh at 1e-5.

The children need free loopback ports (one TCP rendezvous a test).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
CHILD_TIMEOUT_S = 150

# the JAX children's data: identical on both ranks (same seed)
NUM_ROWS, NUM_COLS, NNZ = 64, 24, 800
ALS_RANK, ALS_ITERS, ALS_LAM = 6, 2, 0.1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(child: str, out_dir: str) -> list[str]:
    """Both ranks of ``child``; their stdouts (each must exit 0)."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if not k.startswith(("PIO_", "XLA_", "JAX_"))}
    base.update(PYTHONPATH=REPO, PIO_TEST_OUT=out_dir, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, HERE, child],
        env=dict(base, PIO_NUM_HOSTS="2", PIO_HOST_INDEX=str(idx),
                 PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for idx in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for idx, (code, out, err) in enumerate(outs):
        assert code == 0, f"rank {idx} failed:\n{out}\n{err}"
    return [out for _, out, _ in outs]


def _results(out_dir: str) -> list[dict]:
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(2)]


def _ratings(rng, module):
    return module.RatingsCOO(
        rows=(NUM_ROWS * rng.random(NNZ) ** 1.6).astype(np.int32),
        cols=(NUM_COLS * rng.random(NNZ) ** 1.6).astype(np.int32),
        vals=(rng.random(NNZ) * 5).astype(np.float32),
        num_rows=NUM_ROWS, num_cols=NUM_COLS)


def _oracle_half(V, rows, cols, vals, n_rows) -> np.ndarray:
    out = np.zeros((n_rows, V.shape[1]))
    for u in range(n_rows):
        sel = rows == u
        if not sel.any():
            continue
        F = V[cols[sel]].astype(np.float64)
        r = vals[sel].astype(np.float64)
        A = F.T @ F + ALS_LAM * len(r) * np.eye(V.shape[1])
        out[u] = np.linalg.solve(A, F.T @ r)
    return out


# ---------------------------------------------------------------------------
# the children (port code only)
# ---------------------------------------------------------------------------


def _child_init():
    """Joins the group; (rank, the 4-position device list, its owners)."""
    import torch

    from predictionio_tpu_torch.parallel import distributed

    assert distributed.maybe_initialize_distributed(), "PIO_NUM_HOSTS=2 must join the group"
    assert distributed.maybe_initialize_distributed()   # idempotent
    assert distributed.BACKEND == "gloo", distributed.BACKEND
    assert not torch.cuda.is_initialized()
    import torch.distributed as dist

    devices, owners = distributed.global_devices(["cpu", "cpu"])
    assert [str(d) for d in devices] == ["cpu"] * 4 and owners == [0, 0, 1, 1], owners
    return dist.get_rank(), np.array(devices, dtype=object), np.array(owners)


def _save(rank: int, **arrays) -> None:
    np.savez(os.path.join(os.environ["PIO_TEST_OUT"], f"rank{rank}.npz"), **arrays)


def child_psum() -> None:
    """JAX's ``multihost_child.py``: each rank's (2, 4) rows of a (4, 4)
    array over a 4-position "data" mesh, reduced across ranks; then the
    same array gathered whole and rotated one position by ppermute."""
    from predictionio_tpu_torch.parallel.mesh import (
        COMM, Mesh, NamedSharding, device_put_local, local_map, ppermute, psum)

    rank, devices, owners = _child_init()
    mesh = Mesh(devices, ("data",), ranks=owners)
    assert mesh.multiprocess and len(mesh.local_positions) == 2
    local = np.full((2, 4), float(rank + 1), dtype=np.float32)
    arr = device_put_local(NamedSharding(mesh, ("data",)), local, (4, 4))
    total = psum(local_map(mesh, lambda x: x.sum(0), arr), "data").local(mesh.home)
    np.testing.assert_allclose(total.numpy(), np.full((4,), 6.0))
    whole = arr.gather()
    np.testing.assert_array_equal(whole[:, 0].numpy(), [1, 1, 2, 2])
    rotated = ppermute(arr, "data").gather()
    np.testing.assert_array_equal(rotated[:, 0].numpy(), [2, 1, 1, 2])
    assert COMM["calls"] > 0
    # the context under the group: every rank's devices, in rank order
    from predictionio_tpu_torch.workflow.context import EngineContext

    ctx = EngineContext(device="cpu", devices=["cpu", "cpu"]).with_axes(data=4)
    assert len(ctx.devices) == 4 and ctx.device_ranks == [0, 0, 1, 1]
    assert ctx.mesh.multiprocess and ctx.mesh.local_positions == [(2 * rank,), (2 * rank + 1,)]
    assert ctx.mesh_if_parallel is ctx.mesh
    print(f"RESULT host={rank} total={float(total[0]):.1f}", flush=True)
    _save(rank, total=total.numpy(), whole=whole.numpy(), rotated=rotated.numpy())


def child_als_half() -> None:
    """JAX's ``multihost_als_child.py``: a chunked ALS half-step whose
    slabs each rank stages process-locally (half of every slab's B)."""
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel.mesh import Mesh, NamedSharding, device_put_local

    rank, devices, owners = _child_init()
    mesh = Mesh(devices, ("data",), ranks=owners)
    rng = np.random.default_rng(0)
    coo = _ratings(rng, als)
    chunked = als.chunk_rows(coo, sizes=(8, 4), use_native=False)
    V = (rng.standard_normal((NUM_COLS, ALS_RANK)) / np.sqrt(ALS_RANK)).astype(np.float32)
    slab_sh = NamedSharding(mesh, (None, "data", None))
    vec_sh = NamedSharding(mesh, (None, "data"))
    slabs = []
    for slab in chunked.slabs:
        rids, cols, vals, deg = als.pad_chunk_slab(slab, ALS_RANK, 1 << 12, 4)
        half = rids.shape[1] // 2
        lo, hi = rank * half, (rank + 1) * half
        slabs.append(als.DeviceChunkSlab(
            row_ids=device_put_local(vec_sh, rids[:, lo:hi].astype(np.int64), rids.shape),
            cols=device_put_local(slab_sh, cols[:, lo:hi], cols.shape),
            vals=device_put_local(slab_sh, vals[:, lo:hi], vals.shape),
            deg=device_put_local(vec_sh, deg[:, lo:hi], deg.shape)))
    staged = als.DeviceChunkedRatings(tuple(slabs), NUM_ROWS, NUM_COLS, NNZ)
    V_dev = device_put_local(NamedSharding(mesh, ()), V, V.shape)
    out = als.solve_half(V_dev, staged, ALS_RANK, lam=ALS_LAM, mesh=mesh).numpy()
    np.testing.assert_allclose(out, _oracle_half(V, coo.rows, coo.cols, coo.vals, NUM_ROWS),
                               rtol=2e-3, atol=2e-3)
    print(f"RESULT host={rank} als_half_ok norm={float(np.linalg.norm(out)):.4f}", flush=True)
    _save(rank, table=out)


def child_fused() -> None:
    """JAX's ``multihost_fused_child.py``: two fused iterations with both
    tables row-sharded over "model" on a 2×2 mesh — "data" one index a
    rank, each model shard on both ranks."""
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel.mesh import Mesh, NamedSharding, device_put_local

    rank, devices, owners = _child_init()
    mesh = Mesh(devices.reshape(2, 2), ("data", "model"), ranks=owners.reshape(2, 2))
    rng = np.random.default_rng(0)
    coo = _ratings(rng, als)
    by_user = als.ladder_rows(coo, width=8, small=4, use_native=False)
    by_item = als.ladder_rows(coo.transpose(), width=8, small=4, use_native=False)
    slab_sh = NamedSharding(mesh, (None, "data", None))
    vec_sh = NamedSharding(mesh, (None, "data"))

    def stage(bucketed):
        out = []
        for b in bucketed.buckets:
            cols, vals, deg = als.pad_bucket_slabs(b, ALS_RANK, 1 << 12, 2)
            ids = als.pad_bucket_row_ids(b, deg.shape)
            half = cols.shape[1] // 2
            lo, hi = rank * half, (rank + 1) * half
            out.append(als.DeviceBucket(
                row_ids=device_put_local(vec_sh, ids[:, lo:hi], ids.shape),
                cols=device_put_local(slab_sh, cols[:, lo:hi], cols.shape),
                vals=device_put_local(slab_sh, vals[:, lo:hi], vals.shape),
                deg=device_put_local(vec_sh, deg[:, lo:hi], deg.shape),
                n=int(b.row_ids.shape[0]), pad_len=b.pad_len))
        return als.DeviceBucketedRatings(tuple(out), bucketed.num_rows, bucketed.num_cols,
                                         bucketed.nnz)

    item0 = (rng.standard_normal((NUM_COLS, ALS_RANK)) / np.sqrt(ALS_RANK)).astype(np.float32)
    user, item = als._als_iterate_mesh(
        torch.from_numpy(item0), stage(by_user), stage(by_item), ALS_ITERS, ALS_LAM, 40.0,
        False, False, None, "cg", False, mesh, True, NUM_ROWS, NUM_COLS)
    assert user.spec[0] == "model" and item.spec[0] == "model", user.spec
    user_l, item_l = user.gather().numpy(), item.gather().numpy()
    u_o, i_o = np.zeros((NUM_ROWS, ALS_RANK)), item0.astype(np.float64)
    for _ in range(ALS_ITERS):
        u_o = _oracle_half(i_o, coo.rows, coo.cols, coo.vals, NUM_ROWS)
        i_o = _oracle_half(u_o, coo.cols, coo.rows, coo.vals, NUM_COLS)
    np.testing.assert_allclose(user_l, u_o, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(item_l, i_o, rtol=2e-3, atol=2e-3)
    norm = float(np.linalg.norm(user_l) + np.linalg.norm(item_l))
    print(f"RESULT host={rank} fused_tp_ok norm={norm:.4f}", flush=True)
    _save(rank, user=user_l, item=item_l, item0=item0)


RING_SHAPE = (2, 4, 64, 16)
SEQ_FIELDS = dict(vocab=40, max_len=16, d_model=16, n_heads=2, n_layers=2)
#: "model2_data2": rank 1 owns the positions at "model" index 1 only, so
#: it runs no block and adds zero gradients
SEQ_MESHES = {"data2_seq2": ({"data": 2, "seq": 2}, False),
              "seq4_remat": ({"data": 1, "seq": 4}, True),
              "model2_data2": ({"model": 2, "data": 2}, False)}


def _seq_data():
    rng = np.random.default_rng(7)
    return [[int(x) for x in rng.integers(1, SEQ_FIELDS["vocab"], rng.integers(2, 24))]
            for _ in range(8)]


def _seq_train(mesh, remat: bool):
    """Two Adam steps (8 sequences, batch 4) of seqrec over ``mesh``."""
    import torch

    from predictionio_tpu_torch.models import seqrec

    cfg = seqrec.SeqRecConfig(dtype=torch.float32, remat=remat, **SEQ_FIELDS)
    initial = seqrec.init_params(cfg, torch.Generator().manual_seed(3))
    return seqrec.train(_seq_data(), cfg, epochs=1, batch_size=4, lr=1e-3, seed=3,
                        initial=initial, mesh=mesh)


def child_seq() -> None:
    """Ring attention over a 4-position "seq" mesh split 2 + 2 over the
    ranks (forward, and the gradients of sum(out²)), and two seqrec Adam
    steps over {"data": 2, "seq": 2}, with remat {"data": 1, "seq": 4},
    and {"model": 2, "data": 2}; each beside the same program on an
    in-process mesh."""
    import torch

    from predictionio_tpu_torch.ops.attention import ring_attention
    from predictionio_tpu_torch.parallel.mesh import Mesh

    rank, devices, owners = _child_init()
    rng = np.random.default_rng(11)
    qkv = [torch.tensor(rng.standard_normal(RING_SHAPE), dtype=torch.float32) for _ in range(3)]
    mask = torch.ones(RING_SHAPE[0], RING_SHAPE[2])
    mask[1, 40:] = 0.0
    out = {}
    for name, mesh in (("global", Mesh(devices, ("seq",), ranks=owners)),
                       ("local", Mesh(np.array(["cpu"] * 4, dtype=object), ("seq",)))):
        q, k, v = (t.clone().requires_grad_() for t in qkv)
        o = ring_attention(q, k, v, mesh, causal=True, kv_mask=mask)
        # each rank's positions' outputs are its part of the objective
        S = RING_SHAPE[2]
        own = slice(rank * S // 2, (rank + 1) * S // 2) if name == "global" else slice(None)
        (o[:, :, own] ** 2).sum().backward()
        out[f"ring_{name}"] = o.detach().numpy()
        for t, g in zip("qkv", (q, k, v)):
            out[f"ring_{name}_d{t}"] = g.grad.numpy()
    for tag, (axes, remat) in SEQ_MESHES.items():
        sizes = tuple(axes.values())
        for name, mesh in (
                ("global", Mesh(devices.reshape(sizes), tuple(axes), ranks=owners.reshape(sizes))),
                ("local", Mesh(np.array(["cpu"] * 4, dtype=object).reshape(sizes), tuple(axes)))):
            run = _seq_train(mesh, remat)
            out[f"{tag}_{name}_losses"] = np.array(run.losses)
            for k, v in run.params.items():
                out[f"{tag}_{name}_p_{k}"] = v.numpy()
    print(f"RESULT host={rank} seq_ok", flush=True)
    _save(rank, **out)


CHILDREN = {"psum": child_psum, "als": child_als_half, "fused": child_fused, "seq": child_seq}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_two_process_psum(tmp_path):
    outs = _run_children("psum", str(tmp_path))
    assert "RESULT host=0 total=6.0" in outs[0]
    assert "RESULT host=1 total=6.0" in outs[1]
    r0, r1 = _results(str(tmp_path))
    for key in ("total", "whole", "rotated"):
        np.testing.assert_array_equal(r0[key], r1[key])


def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh as JMesh

    return JMesh(np.asarray(jax.devices()[:4]).reshape(shape), names)


def test_two_process_sharded_als_half_step(tmp_path):
    """The chunked half-step across two ranks against JAX's single-process
    4-device run and the port's in-process 4-position mesh."""
    import jax.numpy as jnp
    import torch

    from predictionio_tpu.ops import als as jals
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel.mesh import Mesh

    outs = _run_children("als", str(tmp_path))
    norms = [o.split("norm=")[1].strip() for o in outs]
    assert "als_half_ok" in outs[0] and "als_half_ok" in outs[1] and norms[0] == norms[1]
    r0, r1 = _results(str(tmp_path))
    np.testing.assert_array_equal(r0["table"], r1["table"])

    rng = np.random.default_rng(0)
    coo_j = _ratings(rng, jals)
    V = (rng.standard_normal((NUM_COLS, ALS_RANK)) / np.sqrt(ALS_RANK)).astype(np.float32)
    want_jax = np.asarray(jals.solve_half(
        jnp.asarray(V), jals.chunk_rows(coo_j, sizes=(8, 4), use_native=False), ALS_RANK,
        ALS_LAM, mesh=_jax_mesh((4,), ("data",)), max_slab_elems=1 << 12))
    np.testing.assert_allclose(r0["table"], want_jax, rtol=0, atol=1e-5)

    rng = np.random.default_rng(0)
    coo = _ratings(rng, als)
    mesh = Mesh(np.array(["cpu"] * 4, dtype=object), ("data",))
    staged = als.stage_chunks(als.chunk_rows(coo, sizes=(8, 4), use_native=False), ALS_RANK,
                              1 << 12, mesh=mesh)
    want = als.solve_half(torch.from_numpy(V), staged, ALS_RANK, ALS_LAM, mesh=mesh).numpy()
    np.testing.assert_allclose(r0["table"], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(r0["table"], _oracle_half(V, coo.rows, coo.cols, coo.vals,
                                                         NUM_ROWS), rtol=2e-3, atol=2e-3)


def _jax_fused(item0: np.ndarray):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding as JSharding, PartitionSpec as P

    from predictionio_tpu.ops import als as jals

    mesh = _jax_mesh((2, 2), ("data", "model"))
    coo = _ratings(np.random.default_rng(0), jals)
    put = jax.device_put

    def stage(bucketed):
        out = []
        for b in bucketed.buckets:
            cols, vals, deg = jals.pad_bucket_slabs(b, ALS_RANK, 2, 1 << 12)
            out.append((put(jnp.asarray(b.row_ids), JSharding(mesh, P())),
                        put(jnp.asarray(cols), JSharding(mesh, P(None, "data", None))),
                        put(jnp.asarray(vals), JSharding(mesh, P(None, "data", None))),
                        put(jnp.asarray(deg), JSharding(mesh, P(None, "data")))))
        return tuple(out)

    bu = stage(jals.ladder_rows(coo, width=8, small=4, use_native=False))
    bi = stage(jals.ladder_rows(coo.transpose(), width=8, small=4, use_native=False))
    item0_dev = put(jnp.asarray(item0), JSharding(mesh, P("model", None)))
    user, item = jals._als_iterate_fused(
        item0_dev, bu, bi, ALS_ITERS, ALS_LAM, 40.0, False, NUM_ROWS, NUM_COLS,
        bf16=False, cg_steps=None, mesh=mesh, shard_factors=True)
    return np.asarray(user), np.asarray(item)


def test_two_process_fused_tp_training_run(tmp_path):
    """Two fused iterations on a 2×2 mesh across two ranks against JAX's
    single-process 2×2 run and the port's in-process 2×2 mesh."""
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel.mesh import Mesh

    outs = _run_children("fused", str(tmp_path))
    norms = [o.split("norm=")[1].strip() for o in outs]
    assert "fused_tp_ok" in outs[0] and "fused_tp_ok" in outs[1] and norms[0] == norms[1]
    r0, r1 = _results(str(tmp_path))
    for side in ("user", "item"):
        np.testing.assert_array_equal(r0[side], r1[side])

    want_user, want_item = _jax_fused(r0["item0"])
    np.testing.assert_allclose(r0["user"], want_user, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r0["item"], want_item, rtol=0, atol=1e-5)

    coo = _ratings(np.random.default_rng(0), als)
    mesh = Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2), ("data", "model"))
    layouts = [als.stage_buckets(als.ladder_rows(c, width=8, small=4, use_native=False),
                                 ALS_RANK, 1 << 12, mesh=mesh) for c in (coo, coo.transpose())]
    user, item = als._als_iterate_mesh(
        torch.from_numpy(r0["item0"]), *layouts, ALS_ITERS, ALS_LAM, 40.0, False, False, None,
        "cg", False, mesh, True, NUM_ROWS, NUM_COLS)
    np.testing.assert_allclose(r0["user"], user.gather().numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(r0["item"], item.gather().numpy(), rtol=0, atol=1e-6)


def test_two_process_ring_attention_and_seqrec_steps(tmp_path):
    """Ring attention across ranks (values and gradients) and two seqrec
    Adam steps over {"data": 2, "seq": 2}, {"data": 1, "seq": 4} (remat)
    and {"model": 2, "data": 2} (one rank runs no block), each equal to
    the in-process mesh's at 1e-5."""
    outs = _run_children("seq", str(tmp_path))
    assert all("seq_ok" in o for o in outs)
    results = _results(str(tmp_path))
    for res in results:
        np.testing.assert_allclose(res["ring_global"], res["ring_local"], rtol=0, atol=1e-5)
        for tag in SEQ_MESHES:
            np.testing.assert_allclose(res[f"{tag}_global_losses"], res[f"{tag}_local_losses"],
                                       rtol=1e-5, atol=0)
            keys = [k for k in res if k.startswith(f"{tag}_local_p_")]
            assert keys
            for k in keys:
                np.testing.assert_allclose(res[k.replace("_local_", "_global_")], res[k],
                                           rtol=0, atol=1e-5, err_msg=k)
    # each rank's gradients hold its positions' blocks (what came back
    # around the ring included) and zeros elsewhere: the two add up to
    # the in-process gradients
    r0, r1 = results
    for t in "qkv":
        np.testing.assert_allclose(r0[f"ring_global_d{t}"] + r1[f"ring_global_d{t}"],
                                   r0[f"ring_local_d{t}"], rtol=0, atol=1e-5)


def test_single_host_noop(monkeypatch):
    """Without PIO_NUM_HOSTS > 1 the initializer stays inert and starts
    no CUDA."""
    import torch

    from predictionio_tpu_torch.parallel import distributed

    monkeypatch.delenv("PIO_NUM_HOSTS", raising=False)
    assert distributed.maybe_initialize_distributed() is False
    monkeypatch.setenv("PIO_NUM_HOSTS", "1")
    assert distributed.maybe_initialize_distributed() is False
    assert not torch.cuda.is_initialized()


def test_missing_coordinator_raises_jax_text(monkeypatch):
    from predictionio_tpu.parallel import distributed as jdist
    from predictionio_tpu_torch.parallel import distributed

    monkeypatch.setenv("PIO_NUM_HOSTS", "2")
    monkeypatch.delenv("PIO_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("PIO_HOST_INDEX", raising=False)
    errors = []
    for module in (jdist, distributed):
        with pytest.raises(RuntimeError) as err:
            module.maybe_initialize_distributed()
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("ranks,want", [
    ([{"host": "a", "cards": 0, "visible": None}] * 2, "gloo"),           # the CPU
    ([{"host": "a", "cards": 1, "visible": None}] * 2, "gloo"),           # one card, two ranks
    ([{"host": "a", "cards": 1, "visible": "0"}, {"host": "a", "cards": 1, "visible": "0"}],
     "gloo"),                                                            # the same card
    ([{"host": "a", "cards": 1, "visible": "0"}, {"host": "a", "cards": 1, "visible": "1"}],
     "nccl"),                                                            # a card each
    ([{"host": "a", "cards": 8, "visible": None}, {"host": "b", "cards": 8, "visible": None}],
     "nccl"),                                                            # a host each
    ([{"host": "a", "cards": 1, "visible": "0"}, {"host": "b", "cards": 0, "visible": None}],
     "gloo"),                                                            # one rank on the CPU
])
def test_backend_follows_the_topology(ranks, want):
    from predictionio_tpu_torch.parallel import distributed

    assert distributed.choose_backend(ranks) == want


def test_compute_commands_join_the_group():
    """The port's CLI joins the group for JAX's four compute commands."""
    from predictionio_tpu.cli import pio as jpio
    from predictionio_tpu_torch.cli import pio

    assert pio.COMPUTE_COMMANDS == jpio.COMPUTE_COMMANDS


if __name__ == "__main__":
    CHILDREN[sys.argv[1]]()
