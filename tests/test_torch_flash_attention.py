"""The port's attention ops held against the JAX package's on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The
JAX flash kernel runs in Pallas interpret mode (``force=True`` on the
CPU backend), as tests/test_attention.py runs it. On the CPU the port's
``flash_attention`` runs its plain version, so these tests pin the
semantics the CUDA kernel is held to on the card (chip_smoke.py and
tests/test_torch_flash_attention_cuda.py).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.attention import full_attention as jax_full_attention
from predictionio_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.attention import full_attention
from predictionio_tpu_torch.utils.device import resolve_device

B, H, S, D = 2, 2, 256, 16


def _inputs(seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(dtype) for _ in range(3))
    mask = np.ones((B, S), dtype=np.float32)
    mask[0, 150:] = 0.0          # right padding
    mask[1, :40] = 0.0           # left padding: the first causal rows see no key
    return q, k, v, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class TestFlashReferenceVsJax:
    """(a) port flash_attention_reference vs JAX flash_attention in
    interpret mode: f32, atol 1e-5 (online vs materialised softmax
    differ by f32 rounding only)."""

    @pytest.mark.parametrize("causal", [True, False])
    def test_padded_mask(self, causal):
        q, k, v, mask = _inputs(0)
        want = np.asarray(jax_flash_attention(
            *map(jnp.asarray, (q, k, v)), causal=causal, kv_mask=jnp.asarray(mask),
            force=True))
        got = flash_ops.flash_attention(*_torch(q, k, v), causal=causal,
                                        kv_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("causal", [True, False])
    def test_no_mask(self, causal):
        q, k, v, _ = _inputs(1)
        want = np.asarray(jax_flash_attention(
            *map(jnp.asarray, (q, k, v)), causal=causal, force=True))
        got = flash_ops.flash_attention_reference(*_torch(q, k, v), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    def test_fully_masked_rows_are_zero(self):
        q, k, v, mask = _inputs(2)
        mask[1] = 0.0
        got = flash_ops.flash_attention_reference(
            *_torch(q, k, v), causal=True, kv_mask=torch.from_numpy(mask)).numpy()
        want = np.asarray(jax_flash_attention(
            *map(jnp.asarray, (q, k, v)), causal=True, kv_mask=jnp.asarray(mask),
            force=True))
        assert np.all(got[1] == 0.0)
        # causal rows 0..39 of batch 0 keep their keys; nothing else zero
        assert np.all(np.abs(got[0]).sum(-1) > 0)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    def test_bf16_output_dtype(self):
        q, k, v, mask = _inputs(3)
        tq, tk, tv = (t.to(torch.bfloat16) for t in _torch(q, k, v))
        got = flash_ops.flash_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask))
        assert got.dtype == torch.bfloat16
        f32 = flash_ops.flash_attention_reference(
            tq.float(), tk.float(), tv.float(), kv_mask=torch.from_numpy(mask))
        # the only bf16 step is the final rounding of the output
        np.testing.assert_allclose(got.float().numpy(), f32.numpy(), atol=1e-2, rtol=8e-3)


def _emulate_bf16_kernel(q, k, v, kv_mask, *, causal: bool, kv_tile: int = 64,
                         consumers: int = 2) -> torch.Tensor:
    """The bf16 CUDA kernel's arithmetic, tile by tile: 64-row query
    tiles; KV tiles of ``kv_tile`` keys (64 in the kernel) dealt in turn
    to ``consumers``
    warpgroups, each with an f32 running max (log2 domain) and
    denominator summed from the f32 P; P rounded to bf16 before the PV
    product, which accumulates in f32; the warpgroups' partial results
    merged at the end; the output rounded to bf16."""
    B, H, S, D = q.shape
    scale = math.log2(math.e) / math.sqrt(D)
    neg = -1e30
    qf, kf, vf = q.float(), k.float(), v.float()
    real = kv_mask > 0
    out = torch.zeros((B, H, S, D))
    for q0 in range(0, S, 64):
        rows = torch.arange(q0, min(q0 + 64, S))
        n_kv = -(-S // kv_tile)
        if causal:
            n_kv = min(n_kv, -(-(q0 + 64) // kv_tile))
        parts = []
        for g in range(consumers):
            m = torch.full((B, H, len(rows), 1), neg)
            l = torch.zeros((B, H, len(rows), 1))
            acc = torch.zeros((B, H, len(rows), D))
            for t in range(g, n_kv, consumers):
                keys = torch.arange(t * kv_tile, min((t + 1) * kv_tile, S))
                logits = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
                valid = real[:, None, None, keys]
                if causal:
                    valid = valid & (keys[None, :] <= rows[:, None])
                logits = torch.where(valid, logits, -math.inf)
                m_new = torch.maximum(m, logits.amax(-1, keepdim=True) * scale)
                alpha = torch.where(m_new > neg / 2, torch.exp2(m - m_new), 0.0)
                p = torch.exp2(logits * scale - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, keys]
                m = m_new
            parts.append((m, l, acc))
        m, l, acc = parts[0]
        for m1, l1, acc1 in parts[1:]:
            mm = torch.maximum(m, m1)
            a0 = torch.where(m > neg / 2, torch.exp2(m - mm), 0.0)
            a1 = torch.where(m1 > neg / 2, torch.exp2(m1 - mm), 0.0)
            m, l, acc = mm, l * a0 + l1 * a1, acc * a0 + acc1 * a1
        out[:, :, rows] = torch.where(l > 0, acc / l.clamp_min(1e-20), 0.0)
    return out.to(torch.bfloat16)


class TestBf16KernelNumerics:
    """The bf16 kernel rounds P to bf16 before PV, where the JAX kernel
    and the plain version keep it f32. Its emulation, fed bf16 inputs at
    (1, 2, 512, 64), causal, with left-masked and padded keys, stays
    within the card's bf16 tolerance (atol 1e-2 + rtol 8e-3) of the JAX
    kernel in interpret mode and of ``flash_attention_reference``, and
    without the causal mask as well."""

    TOL = dict(atol=1e-2, rtol=8e-3)

    @pytest.fixture(scope="class")
    def inputs(self):
        rng = np.random.default_rng(7)
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 512, 64)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(3))
        mask = np.ones((1, 512), dtype=np.float32)
        mask[0, :40] = 0.0       # left padding: causal rows 0..39 see no key
        mask[0, 450:] = 0.0      # right padding
        return q, k, v, torch.from_numpy(mask)

    @pytest.mark.parametrize("causal", [True, False])
    def test_emulation_vs_jax(self, inputs, causal):
        q, k, v, mask = inputs
        jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
        want = jax_flash_attention(jq, jk, jv, causal=causal, kv_mask=jnp.asarray(mask.numpy()),
                                   force=True)
        got = _emulate_bf16_kernel(q, k, v, mask, causal=causal)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   **self.TOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_emulation_vs_reference(self, inputs, causal):
        q, k, v, mask = inputs
        got = _emulate_bf16_kernel(q, k, v, mask, causal=causal)
        want = flash_ops.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **self.TOL)

    def test_rows_without_a_key_are_zero(self, inputs):
        q, k, v, mask = inputs
        got = _emulate_bf16_kernel(q, k, v, mask, causal=True)
        assert torch.all(got[:, :, :40] == 0)
        assert torch.all(got[:, :, 40:].float().abs().sum(-1) > 0)


class TestFullAttentionVsJax:
    """(b) port full_attention vs JAX full_attention, f32, atol 1e-5 —
    including its uniform average over V for fully-masked rows."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("masked", [True, False])
    def test_matches(self, causal, masked):
        q, k, v, mask = _inputs(4)
        kw_j = {"kv_mask": jnp.asarray(mask)} if masked else {}
        kw_t = {"kv_mask": torch.from_numpy(mask)} if masked else {}
        want = np.asarray(jax_full_attention(*map(jnp.asarray, (q, k, v)),
                                             causal=causal, **kw_j))
        got = full_attention(*_torch(q, k, v), causal=causal, **kw_t)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    def test_flash_equals_full_where_rows_see_a_key(self):
        q, k, v, mask = _inputs(5)
        tq, tk, tv, tm = _torch(q, k, v, mask)
        full = full_attention(tq, tk, tv, causal=True, kv_mask=tm).numpy()
        flash = flash_ops.flash_attention(tq, tk, tv, causal=True, kv_mask=tm).numpy()
        # rows 0..39 of batch 1 see no key (left padding): flash gives 0,
        # full attention the uniform average of V
        np.testing.assert_allclose(flash[0], full[0], atol=1e-5)
        np.testing.assert_allclose(flash[1, :, 40:], full[1, :, 40:], atol=1e-5)
        assert np.all(flash[1, :, :40] == 0.0)
        np.testing.assert_allclose(full[1, :, 0], v[1].mean(axis=1), atol=1e-5)


class TestWrapperContract:
    """(f) what the wrapper refuses, and that the CPU path is not a launch."""

    @pytest.mark.parametrize("odd", ["q", "k", "v", "out"])
    def test_misaligned_bf16_launch_raises(self, odd):
        shape = (1, 1, 64, 64)
        ts = {n: torch.zeros(shape, dtype=torch.bfloat16) for n in ("q", "k", "v", "out")}
        # a contiguous view one element (2 bytes) into its buffer
        ts[odd] = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16)[1:].view(shape)
        assert ts[odd].is_contiguous() and ts[odd].data_ptr() % 16
        with pytest.raises(ValueError, match=f"16-byte aligned.*{odd} not aligned"):
            flash_ops._launch(ts["q"], ts["k"], ts["v"], torch.ones((1, 64)), ts["out"], True)

    def test_cpu_path_does_not_count_launches(self):
        q, k, v, mask = _inputs(6)
        before = flash_ops.LAUNCHES
        flash_ops.flash_attention(*_torch(q, k, v), kv_mask=torch.from_numpy(mask))
        assert flash_ops.LAUNCHES == before

    @pytest.mark.parametrize("d", [8, 24, 48, 256])
    def test_unsupported_head_dim_raises(self, d):
        q = torch.zeros((1, 1, 8, d))
        with pytest.raises(ValueError, match="head dim"):
            flash_ops.flash_attention(q, q, q)

    @pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
    def test_unsupported_dtype_raises(self, dtype):
        q = torch.zeros((1, 1, 8, 16), dtype=dtype)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            flash_ops.flash_attention(q, q, q)

    def test_mixed_dtypes_raise(self):
        q = torch.zeros((1, 1, 8, 16))
        with pytest.raises(TypeError):
            flash_ops.flash_attention(q, q.to(torch.bfloat16), q)

    def test_non_contiguous_raises(self):
        q = torch.zeros((1, 8, 2, 16)).transpose(1, 2)
        assert not q.is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            flash_ops.flash_attention(q, q, q)

    def test_shape_and_mask_checks(self):
        q = torch.zeros((1, 1, 8, 16))
        with pytest.raises(ValueError, match="shape"):
            flash_ops.flash_attention(q, torch.zeros((1, 1, 9, 16)), q)
        with pytest.raises(ValueError, match="kv_mask"):
            flash_ops.flash_attention(q, q, q, kv_mask=torch.ones((1, 9)))

    def test_tensor_off_cpu_and_cuda_raises(self):
        q = torch.zeros((1, 1, 8, 16), device="meta")
        with pytest.raises(ValueError, match="cuda"):
            flash_ops.flash_attention(q, q, q, kv_mask=torch.ones((1, 8), device="meta"))

    def test_cuda_request_without_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
        assert resolve_device("cpu") == torch.device("cpu")

    def test_unknown_device_type_raises(self):
        with pytest.raises(ValueError):
            resolve_device("meta")


class TestBuild:
    def test_sources_and_library_name(self):
        assert "flash_attention" in _build.kernel_names()
        path = _build.library_path("flash_attention")
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith("libflash_attention-") and path.suffix == ".so"
        assert path == _build.library_path("flash_attention")   # stable hash

    def test_flags_target_sm90a(self):
        flags = " ".join(_build.NVCC_FLAGS)
        assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc"):
            _build._nvcc()
