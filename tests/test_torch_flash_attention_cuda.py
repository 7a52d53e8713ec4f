"""The flash-attention CUDA kernel against its plain version, on the card.

Needs an NVIDIA card (sm_90a) and nvcc; every test skips without them.
Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_flash_attention_cuda.py --noconftest
"""

from __future__ import annotations

import pytest
import torch

from predictionio_tpu_torch.ops import flash_attention as flash_ops

pytestmark = pytest.mark.cuda

#: f32 (CUDA cores) differs from the plain version by summation order;
#: bf16 (tensor cores) by a rounding step of the output and the bf16
#: rounding of P before the PV product
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 200])
def test_kernel_matches_plain(cuda, dtype, d, causal, s):
    gen = torch.Generator(device=cuda).manual_seed(d + s)
    q, k, v = (torch.randn((2, 3, s, d), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    mask = torch.ones((2, s), device=cuda)
    mask[0, s // 2:] = 0.0
    mask[1, : s // 5] = 0.0
    before = flash_ops.LAUNCHES
    got = flash_ops.flash_attention(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    want = flash_ops.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_fully_masked_batch_row_is_zero(cuda):
    q = torch.randn((2, 1, 100, 64), device=cuda)
    mask = torch.ones((2, 100), device=cuda)
    mask[1] = 0.0
    out = flash_ops.flash_attention(q, q, q, causal=False, kv_mask=mask)
    assert torch.all(out[1] == 0)
    assert torch.all(out[0].abs().sum(-1) > 0)


def _masked(cuda, b, s, kind):
    mask = torch.ones((b, s), device=cuda)
    if kind == "pad":            # each row shorter; row 1 has no real key at all
        mask[0, s // 2:] = 0.0
        mask[1:] = 0.0
    elif kind == "left":         # the first causal rows see no key
        mask[:, : s // 4] = 0.0
    return mask


# (B, H, S, D, causal, mask): the bf16 kernel's edges. S=17 is less than
# one tile, S=2049 one past a tile, S=8192 wraps the K/V ring many times.
BF16_EDGES = [
    (1, 2, 17, 64, True, None),
    (2, 2, 2049, 64, True, "left"),
    (1, 2, 8192, 64, True, None),
    *[(2, 2, 300, d, c, kind) for d in (16, 32, 64, 128) for c in (True, False)
      for kind in ("pad", "left")],
]


@pytest.mark.parametrize("b,h,s,d,causal,kind", BF16_EDGES)
def test_bf16_kernel_edges(cuda, b, h, s, d, causal, kind):
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    mask = _masked(cuda, b, s, kind)
    got = flash_ops.flash_attention(q, k, v, causal=causal, kv_mask=mask)
    want = flash_ops.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    if kind == "pad":
        assert torch.all(got[1] == 0)
    if kind == "left" and causal:
        assert torch.all(got[:, :, : s // 4] == 0)

