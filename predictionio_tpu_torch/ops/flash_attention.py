"""Forward flash attention: the port's counterpart of the JAX package's
``ops/pallas_attention.py``.

``flash_attention`` keeps the JAX signature and layout (B, H, S, D).
On a CUDA tensor it launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (built by ops/_build.py at first use) for
every S, and raises if it cannot: there is no envelope on the card yet
and no fallback. bfloat16 goes through the tensor cores (wgmma, 64-key
K/V tiles fed by TMA, so q, k and v must be 16-byte aligned; P is
rounded to bf16 before the PV product); float32 through the CUDA cores,
exactly. On a CPU tensor
it runs ``flash_attention_reference``, the plain PyTorch version with
the same semantics, which the tests hold against the JAX kernel in
interpret mode and ``chip_smoke.py`` holds the CUDA kernel against on
the card.

Semantics (those of the Pallas ``_flash_kernel``): scale 1/sqrt(D); a
per-key mask (B, S) shared by the heads; an optional causal mask;
softmax statistics in f32; a row with no valid key gets ZERO output
(``ops/attention.full_attention`` gives the uniform average of V there
instead). Output is in q's dtype. Forward only: a call with grad enabled
on a q, k or v that requires grad raises, on either device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from contextvars import ContextVar
from typing import Callable

import torch

#: kernel launches since import (or the last reset by the caller):
#: incremented once per launch of the CUDA kernel, and nowhere else
LAUNCHES = 0

#: set by ``obs/device.count_flops`` (in its own context) while a train
#: run is profiled: called with each launch's FLOPs, which
#: FlopCounterMode does not see in a ctypes launch
flop_hook: ContextVar[Callable[[int], None] | None] = ContextVar(
    "pio_flash_flop_hook", default=None)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
_NEG = -1e30


def _check(q, k, v, kv_mask) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not supported (one of {HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if kv_mask is not None and tuple(kv_mask.shape) != (q.shape[0], q.shape[2]):
        raise ValueError(f"kv_mask must be (B, S) = {(q.shape[0], q.shape[2])}; "
                         f"got {tuple(kv_mask.shape)}")
    devices = {t.device for t in (q, k, v) + (() if kv_mask is None else (kv_mask,))}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and kv_mask must be on one device; got {devices}")


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch flash semantics, materialising the (S, S) logits:
    the kernel's arithmetic in f32, with zero output for rows whose
    keys are all masked."""
    B, H, S, D = q.shape
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * (1.0 / math.sqrt(D))
    if kv_mask is None:
        valid = torch.ones((B, 1, 1, S), dtype=torch.bool, device=q.device)
    else:
        valid = (kv_mask > 0)[:, None, None, :]
    if causal:
        valid = valid & torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(valid, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid & (m > _NEG / 2), torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ v.float()) / l.clamp_min(1e-20)
    return torch.where(l > 0, out, 0.0).to(q.dtype)


@functools.cache
def _kernel_fn():
    """The kernel's C entry point, built and loaded at first use."""
    from predictionio_tpu_torch.ops._build import load_kernel_library

    fn = load_kernel_library("flash_attention").pio_flash_attention_fwd
    # q, k, v, kv_mask, out; batch_heads, heads, seq_len, head_dim,
    # dtype, causal; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, mask, out, causal: bool) -> None:
    """One launch on preallocated tensors. Does not count in ``LAUNCHES``."""
    if q.dtype == torch.bfloat16:
        # the bf16 kernel reads q, k and v by TMA, which takes 16-byte
        # aligned addresses; out is held to the same
        names = ("q", "k", "v", "out")
        odd = [n for n, t in zip(names, (q, k, v, out)) if t.data_ptr() % 16]
        if odd:
            raise ValueError(f"the bfloat16 flash_attention kernel needs 16-byte aligned "
                             f"q, k, v and out; {', '.join(odd)} not aligned")
    fn = _kernel_fn()
    B, H, S, D = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
             B * H, H, S, D, _DTYPE_CODES[q.dtype], int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention CUDA kernel failed to launch: cudaError {err} "
                           f"(shape {tuple(q.shape)}, {q.dtype}, causal={causal})")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Streaming-tile attention over (B, H, S, D); kv_mask (B, S) is
    1 for real keys and 0 for padding. CUDA tensors go through the
    kernel, CPU tensors through :func:`flash_attention_reference`;
    other devices raise."""
    global LAUNCHES
    _check(q, k, v, kv_mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # the kernel writes into a fresh tensor with no grad_fn: q, k and v
        # would silently get no gradient from attention
        raise RuntimeError(
            "flash_attention is forward-only and q, k or v requires grad; train "
            "through ops/attention.full_attention or blockwise_attention, or call "
            "it under torch.no_grad() / torch.inference_mode()")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, kv_mask=kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu (reference), "
                         f"not {q.device}")
    B, _, S, _ = q.shape
    if kv_mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=q.device)
    else:
        mask = kv_mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    _launch(q, k, v, mask, out, causal)
    LAUNCHES += 1
    hook = flop_hook.get()
    if hook is not None:
        hook(launch_flops(q, mask, causal))
    return out


def launch_flops(q: torch.Tensor, mask: torch.Tensor, causal: bool) -> int:
    """The FLOPs of one launch: QK^T and PV, 4·D per (query, key) pair
    whose key is real under ``mask`` (B, S) and, causal, at or before its
    query — a key at position j meets the S - j queries from j on. Reads
    the mask's count back to the host."""
    B, H, S, D = q.shape
    per_key = (S - torch.arange(S, device=mask.device, dtype=torch.float64) if causal
               else torch.full((S,), float(S), device=mask.device, dtype=torch.float64))
    pairs = int(((mask > 0).double() * per_key).sum().item())
    return 4 * D * H * pairs
