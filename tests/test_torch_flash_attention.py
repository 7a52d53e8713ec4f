"""The port's attention ops held against the JAX package's on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The
JAX flash kernel runs in Pallas interpret mode (``force=True`` on the
CPU backend), as tests/test_attention.py runs it. On the CPU the port's
``flash_attention`` runs its plain version, so these tests pin the
semantics the CUDA kernel is held to on the card (chip_smoke.py and
tests/test_torch_flash_attention_cuda.py).
"""

from __future__ import annotations

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
