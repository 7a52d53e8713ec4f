"""The port's ring attention (``ops/attention.ring_attention``) held
against the JAX package's on the CPU: JAX's six ``TestRingAttention``
cases (``tests/test_attention.py``), each over a "seq" axis of 2, 4 and 8
positions (the port's mesh ``["cpu"] * n``, JAX's the conftest's first n
CPU devices), on the same numpy-seeded inputs.

Tolerances are JAX's own for ring against full attention: f32 values
1e-5, bf16 values 3e-2, gradients 1e-4 (the same online softmax, step for
step, in f32; the two frameworks differ in summation order only).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding as JSharding, PartitionSpec as P

from predictionio_tpu.ops import attention as jattention
from predictionio_tpu_torch.ops import attention
from predictionio_tpu_torch.parallel.mesh import Mesh, NamedSharding, ShardedArray, device_put

B, H, S, D = 2, 4, 64, 16   # S divides every seq axis below
SEQ = [2, 4, 8]
F32, BF16, GRAD = 1e-5, 3e-2, 1e-4


def _qkv(seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3)]


def _meshes(n: int):
    return (JMesh(np.asarray(jax.devices()[:n]), ("seq",)),
            Mesh(np.array(["cpu"] * n, dtype=object), ("seq",)))


def _jax_ring(jmesh, causal: bool = True):
    """JAX's ring attention on ``jmesh``, jitted (one compile a case)."""
    return jax.jit(functools.partial(jattention.ring_attention, mesh=jmesh, causal=causal))


def _padding_mask() -> np.ndarray:
    mask = np.ones((B, S), dtype=np.float32)
    mask[1, 40:] = 0.0   # the second sequence has 40 real positions
    return mask


@pytest.mark.parametrize("n", SEQ)
class TestRingAttentionVsJax:
    @pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
    def test_matches_jax(self, n, causal):
        """JAX's test_matches_full_causal and test_matches_full_noncausal."""
        arrays = _qkv(0 if causal else 1)
        jmesh, mesh = _meshes(n)
        want = _jax_ring(jmesh, causal)(*map(jnp.asarray, arrays))
        got = attention.ring_attention(*map(torch.from_numpy, arrays), mesh, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32, rtol=F32)
        full = attention.full_attention(*map(torch.from_numpy, arrays), causal=causal)
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=F32, rtol=F32)

    def test_padding_mask(self, n):
        arrays = _qkv(2)
        mask = _padding_mask()
        jmesh, mesh = _meshes(n)
        want = _jax_ring(jmesh)(*map(jnp.asarray, arrays), kv_mask=jnp.asarray(mask))
        got = attention.ring_attention(*map(torch.from_numpy, arrays), mesh, causal=True,
                                       kv_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32, rtol=F32)

    def test_sharded_inputs(self, n):
        """JAX's test_inside_jit_with_sharded_inputs: shards in, shards out
        (B, H, S/n, D) on the mesh's positions."""
        arrays = _qkv(3)
        jmesh, mesh = _meshes(n)
        sh = JSharding(jmesh, P(None, None, "seq", None))
        run = jax.jit(lambda q, k, v: jattention.ring_attention(q, k, v, jmesh, causal=True))
        want = run(*(jax.device_put(jnp.asarray(x), sh) for x in arrays))
        spec = NamedSharding(mesh, (None, None, "seq", None))
        q, k, v = (device_put(torch.from_numpy(x), spec) for x in arrays)
        mask = device_put(torch.ones(B, S), NamedSharding(mesh, (None, "seq")))
        out = attention.ring_attention_sharded(q, k, v, mask, causal=True)
        assert isinstance(out, ShardedArray) and out.spec == (None, None, "seq", None)
        assert all(tuple(s.shape) == (B, H, S // n, D) for s in out.shards)
        np.testing.assert_allclose(out.gather().numpy(), np.asarray(want), atol=F32, rtol=F32)

    def test_bf16_inputs_accumulate_f32(self, n):
        arrays = _qkv(4)
        jmesh, mesh = _meshes(n)
        want = _jax_ring(jmesh)(*(jnp.asarray(x, dtype=jnp.bfloat16) for x in arrays))
        got = attention.ring_attention(*(torch.from_numpy(x).bfloat16() for x in arrays), mesh,
                                       causal=True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                                   atol=BF16, rtol=BF16)

    def test_grads_match_jax(self, n):
        """JAX's test_grads_flow: the gradients of sum(out²) with respect to
        q, k and v, through the ring and back."""
        arrays = _qkv(5)
        jmesh, mesh = _meshes(n)
        want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jattention.ring_attention(
            q, k, v, jmesh, causal=True) ** 2), argnums=(0, 1, 2)))(*map(jnp.asarray, arrays))
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in arrays)
        (attention.ring_attention(q, k, v, mesh, causal=True) ** 2).sum().backward()
        for got, w in zip((q.grad, k.grad, v.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD, rtol=GRAD)


@pytest.mark.parametrize("n", SEQ)
def test_whole_tensors_equal_shards_in_and_out(n):
    """The helper on whole tensors equals the sharded function, shards in
    and out, bit for bit, with a padding mask."""
    arrays = _qkv(6)
    mask = torch.from_numpy(_padding_mask())
    _, mesh = _meshes(n)
    whole = attention.ring_attention(*map(torch.from_numpy, arrays), mesh, kv_mask=mask)
    spec = NamedSharding(mesh, (None, None, "seq", None))
    out = attention.ring_attention_sharded(
        *(device_put(torch.from_numpy(x), spec) for x in arrays),
        device_put(mask, NamedSharding(mesh, (None, "seq"))))
    for pos in mesh.positions:
        i = pos[0]
        assert torch.equal(out.local(pos), whole[:, :, i * S // n:(i + 1) * S // n])


def test_batch_axis_beside_the_ring():
    """A (data, seq) mesh with the batch split over "data": each data row
    of positions runs its own ring, equal to JAX's ring on the same mesh."""
    arrays = _qkv(7)
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "seq"))
    mesh = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4), ("data", "seq"))
    want = _jax_ring(jmesh)(*map(jnp.asarray, arrays))
    spec = NamedSharding(mesh, ("data", None, "seq", None))
    out = attention.ring_attention_sharded(
        *(device_put(torch.from_numpy(x), spec) for x in arrays),
        device_put(torch.ones(B, S), NamedSharding(mesh, ("data", "seq"))))
    np.testing.assert_allclose(out.gather().numpy(), np.asarray(want), atol=F32, rtol=F32)


def test_seq_must_divide_the_axis():
    _, mesh = _meshes(8)
    q = torch.zeros(1, 1, 12, 4)
    with pytest.raises(ValueError, match="does not divide"):
        attention.ring_attention(q, q, q, mesh)
