"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), and the build of every
   CUDA kernel under predictionio_tpu_torch/csrc/ with nvcc for sm_90a;
2. each kernel against its plain PyTorch version on the card, case by
   case, with the max abs difference and the tolerance;
3. the kernel's time at the serving shape and the batch bucket beside
   the plain version, the library call (scaled_dot_product_attention
   with the same mask, and with is_causal alone, yardsticks the port
   never calls) and the bound: CUDA events around 100 back-to-back
   launches on preallocated tensors, divided by 100 (inputs stay in
   L2, as after the layer that wrote them), the kernel's device time
   from torch.profiler, and the kernel against the library call at B=1
   for S in {512, 8192};
4. the sessionrec serving path end to end at the long-context serving
   config (vocab 50,000, max_len 2048, d_model 256, 4 heads, 4 layers,
   bf16, random weights from a seed): save the model, deploy it through
   the port's engine server, POST queries, and check every answer, the
   kernel's launches per query, and the top-10 against the same model
   run with the plain attention;
5. a `kernels` JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Exits non-zero, printing no result, when there is no card.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from predictionio_tpu_torch.api.engine_server import EngineServerConfig, create_engine_server
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.templates import sessionrec

SEED = 0
DEVICE = "cuda"
#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 on
#: the CUDA cores, and device-memory bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
#: kernel vs plain: f32 differs by summation order; bf16 by a rounding
#: step of the output and by the bf16 rounding of P before the PV product
TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 8e-3)}  # (atol, rtol)
SERVING = dict(vocab=50_000, max_len=2048, d_model=256, n_heads=4, n_layers=4)
#: top-10 agreement, served (kernel) vs plain attention: logits are f32
#: sums over bf16 hidden states, which differ by bf16 rounding steps
SCORE_TOL = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


LAUNCHES_TIMED = 100
#: keys per K/V tile of the bf16 kernel (kKvTile in csrc/flash_attention.cu)
KV_TILE = 64


def time_ms(fn, warmup: int = 10, n: int = LAUNCHES_TIMED) -> float:
    """ms per call: CUDA events around n back-to-back calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profiled_ms(fn, name: str, n: int = 20) -> float | None:
    """The device time per call of the kernels whose name holds `name`,
    from torch.profiler's CUDA activity; None where it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages() if name in e.key)
    return total_us / n / 1e3 if total_us > 0 else None


def attention_bound_ms(B, H, S, D, dtype, causal) -> tuple[float, str]:
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * D * pairs * B * H                     # QK^T and PV
    nbytes = 4 * B * H * S * D * torch.finfo(dtype).bits // 8 + B * S * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def qkv(B, H, S, D, dtype, gen):
    return [torch.randn((B, H, S, D), generator=gen, device=DEVICE).to(dtype)
            for _ in range(3)]


def phase_build() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} kernel(s) compiled in {time.perf_counter() - t0:.1f}s "
        f"into {_build.BUILD_DIR}")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = found.group(1)  # mangled: flash_fwd_bf16_wgmmaILi64EE... is D=64
            elif "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {name} {entry}: {line.strip()}")


def phase_kernel_vs_plain() -> float:
    """Returns the max abs error at the serving shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    # (label, B, H, S, D, dtype, causal, mask) — mask "pad": each row a
    # different real length, row 1 fully masked; "left": the first keys
    # masked, so the first causal rows see no key at all
    cases = [
        ("causal f32 D64 padded", 2, 2, 256, 64, torch.float32, True, "pad"),
        # bf16 (wgmma) edges: a tile of 17 keys, one past a tile, a ring
        # wrapped many times, every head dim both ways, masked rows
        ("S=17 causal bf16 D64", 1, 2, 17, 64, torch.bfloat16, True, None),
        ("S=2049 causal bf16 D64 left-masked", 2, 2, 2049, 64, torch.bfloat16, True, "left"),
        ("S=8192 causal bf16 D64", 1, 2, 8192, 64, torch.bfloat16, True, None),
        ("causal bf16 D16 padded", 2, 2, 300, 16, torch.bfloat16, True, "pad"),
        ("non-causal bf16 D16 left-masked", 2, 2, 300, 16, torch.bfloat16, False, "left"),
        ("causal bf16 D32 left-masked", 2, 2, 300, 32, torch.bfloat16, True, "left"),
        ("non-causal bf16 D32 padded", 2, 2, 300, 32, torch.bfloat16, False, "pad"),
        ("causal bf16 D64 padded", 2, 2, 300, 64, torch.bfloat16, True, "pad"),
        ("non-causal bf16 D64 left-masked", 2, 2, 300, 64, torch.bfloat16, False, "left"),
        ("non-causal f32 D64 padded", 2, 2, 256, 64, torch.float32, False, "pad"),
        ("causal f32 D16 left-masked", 2, 3, 192, 16, torch.float32, True, "left"),
        ("causal bf16 D16", 1, 2, 512, 16, torch.bfloat16, True, None),
        ("non-causal bf16 D128 padded", 2, 2, 384, 128, torch.bfloat16, False, "pad"),
        ("causal bf16 D128 left-masked", 2, 2, 256, 128, torch.bfloat16, True, "left"),
        ("ragged S=1000 causal f32 D32 padded", 2, 2, 1000, 32, torch.float32, True, "pad"),
        ("ragged S=1000 non-causal bf16 D64", 1, 4, 1000, 64, torch.bfloat16, False, None),
        ("serving (1,4,2048,64) bf16 causal", 1, 4, 2048, 64, torch.bfloat16, True, None),
        ("bucket (8,4,2048,64) bf16 causal padded", 8, 4, 2048, 64, torch.bfloat16, True, "pad"),
    ]
    serving_err = None
    for label, B, H, S, D, dtype, causal, kind in cases:
        q, k, v = qkv(B, H, S, D, dtype, gen)
        mask = None
        if kind == "pad":
            lengths = torch.linspace(S, S // 3, B).long()
            mask = (torch.arange(S)[None, :] < lengths[:, None]).float().to(DEVICE)
            if B > 1:
                mask[1] = 0.0
        elif kind == "left":
            mask = torch.ones((B, S), device=DEVICE)
            mask[:, : S // 4] = 0.0
        got = flash_ops.flash_attention(q, k, v, causal=causal, kv_mask=mask)
        want = flash_ops.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
        torch.cuda.synchronize()
        atol, rtol = TOL[dtype]
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got.float()).all()) and torch.allclose(
            got.float(), want.float(), atol=atol, rtol=rtol)
        log(f"[check] {label}: max_abs_err={err:.3e} tol=atol {atol:g} + rtol {rtol:g}"
            f" {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attention kernel disagrees with its plain version: {label}")
        if kind == "pad" and B > 1 and got[1].abs().max().item() != 0.0:
            fail(f"fully-masked row not zero: {label}")
        if kind == "left" and causal and got[:, :, : S // 4].abs().max().item() != 0.0:
            fail(f"causal rows that see no key not zero: {label}")
        if label.startswith("serving"):
            serving_err = err
    return serving_err


def phase_times() -> dict:
    """Kernel, plain and library times at B=1 and B=8 (S=2048, D=64,
    bf16, causal, every key real), then the B=1 envelope at S=512 and
    8192. Returns the serving shape's numbers for the kernels line."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    atol, rtol = TOL[torch.bfloat16]
    out = {}
    for B in (1, 8):
        H, S, D, dtype = 4, 2048, 64, torch.bfloat16
        q, k, v = qkv(B, H, S, D, dtype, gen)
        mask = torch.ones((B, S), device=DEVICE)
        bool_mask = (mask[:, None, None, :] > 0) & torch.ones(
            (S, S), dtype=torch.bool, device=DEVICE).tril()
        res = torch.empty_like(q)
        want = flash_ops.flash_attention_reference(q, k, v, causal=True, kv_mask=mask)
        kernel_ms = time_ms(lambda: flash_ops._launch(q, k, v, mask, res, True))
        if not torch.allclose(res.float(), want.float(), atol=atol, rtol=rtol):
            fail(f"the timed launches disagree with the plain version at ({B},{H},{S},{D})")
        device_ms = profiled_ms(lambda: flash_ops._launch(q, k, v, mask, res, True),
                                "flash_fwd_bf16_wgmma")
        plain_ms = time_ms(lambda: flash_ops.flash_attention_reference(
            q, k, v, causal=True, kv_mask=mask))
        library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=bool_mask))
        library_causal_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True))
        bound_ms, bound_by = attention_bound_ms(B, H, S, D, dtype, True)
        log(f"[time] flash_attention ({B},{H},{S},{D}) bf16 causal, {LAUNCHES_TIMED} launches: "
            f"kernel_ms={kernel_ms:.4f} "
            f"kernel_device_ms={'not recorded' if device_ms is None else f'{device_ms:.4f}'} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"library_causal_ms={library_causal_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"roofline_share={bound_ms / kernel_ms:.4f}")
        out[B] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=library_ms, library_causal_ms=library_causal_ms)
        del bool_mask
    for S in (512, 8192):
        q, k, v = qkv(1, 4, S, 64, torch.bfloat16, gen)
        mask = torch.ones((1, S), device=DEVICE)
        bool_mask = torch.ones((S, S), dtype=torch.bool, device=DEVICE).tril()[None, None]
        res = torch.empty_like(q)
        kernel_ms = time_ms(lambda: flash_ops._launch(q, k, v, mask, res, True))
        device_ms = profiled_ms(lambda: flash_ops._launch(q, k, v, mask, res, True),
                                "flash_fwd_bf16_wgmma")
        library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=bool_mask))
        library_causal_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True))
        log(f"[envelope] (1,4,{S},64) bf16 causal, {LAUNCHES_TIMED} launches: "
            f"kernel_ms={kernel_ms:.4f} "
            f"kernel_device_ms={'not recorded' if device_ms is None else f'{device_ms:.4f}'} "
            f"library_ms={library_ms:.4f} "
            f"library_causal_ms={library_causal_ms:.4f} "
            f"kernel/library={kernel_ms / library_ms:.3f} "
            f"kernel/library_causal={kernel_ms / library_causal_ms:.3f}")
        del bool_mask
    return out[1]


def _post(port: int, body: dict) -> tuple[int, dict, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, doc = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        status, doc = e.code, json.loads(e.read() or b"{}")
    return status, doc, (time.perf_counter() - t0) * 1e3


def _reference_logits(model, tail: list[int], black: list[int]) -> torch.Tensor:
    """f32 logits (V,) of the served model with the plain attention, masked
    as the algorithm masks them."""
    S, V = model.cfg.max_len, model.cfg.vocab
    hist = torch.zeros((1, S), dtype=torch.long)
    hist[0, : len(tail)] = torch.tensor(tail)
    module = model.as_module()
    with torch.inference_mode():
        h = module(hist.to(DEVICE), attention=flash_ops.flash_attention_reference)
        logits = seqrec.logits_from_hidden(module, h[0, len(tail) - 1])
    vm = torch.zeros(V, device=DEVICE)
    vm[0] = -1e30
    vm[torch.tensor(tail + black, device=DEVICE)] = -1e30
    return logits + vm


def phase_serving() -> int:
    cfg = seqrec.SeqRecConfig(**SERVING, dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    item_ids = [f"i{n}" for n in range(1, cfg.vocab)]
    users = [f"u{n}" for n in range(8)]
    histories = {u: [item_ids[j] for j in rng.integers(0, len(item_ids), 2048 + 64 * n)]
                 for n, u in enumerate(users)}
    t0 = time.perf_counter()
    model = sessionrec.init_engine_model(cfg, item_ids, histories, seed=SEED, device=DEVICE)
    model_dir = tempfile.mkdtemp(prefix="seqrec-model-")
    server = None
    try:
        sessionrec.save_engine_model(model, model_dir)
        server = create_engine_server(EngineServerConfig(
            model_dir=model_dir, ip="127.0.0.1", port=0, device=DEVICE)).start()
        port = server.port
        log(f"[serve] model saved, deployed and listening on :{port} in "
            f"{time.perf_counter() - t0:.1f}s")
        deployed = server.deployed.models[0]
        pick = [item_ids[j] for j in rng.integers(0, len(item_ids), 300)]
        queries = [
            {"user": "u0", "num": 10},
            {"user": "u1", "num": 5},
            {"user": "u2", "num": 20, "blackList": pick[:30]},
            {"user": "u3", "num": 10},
            {"items": pick[30:130], "num": 10},
            {"items": pick[130:300], "num": 20, "blackList": pick[:10]},
            {"user": "u4", "num": 5, "blackList": pick[200:220]},
            {"user": "u5", "num": 10},
            {"user": "u6", "num": 20},
            {"user": "u7", "num": 10},
        ]
        # warm-up (first CUDA calls, allocator): outside the counted run
        status, _, _ = _post(port, {"user": "u0", "num": 10})
        if status != 200:
            fail(f"warm-up query answered {status}")

        flash_ops.LAUNCHES = 0
        answers, rtts, per_query = [], [], []
        for body in queries:
            before = flash_ops.LAUNCHES
            status, doc, ms = _post(port, body)
            per_query.append(flash_ops.LAUNCHES - before)
            answers.append((status, doc))
            rtts.append(ms)
        launches = flash_ops.LAUNCHES

        index = deployed.item_index
        for body, (status, doc), n, ms in zip(queries, answers, per_query, rtts):
            if status != 200:
                fail(f"query {body} answered {status}: {doc}")
            scores = doc.get("itemScores", [])
            if len(scores) != body["num"]:
                fail(f"query asked num={body['num']}, got {len(scores)} itemScores")
            if n != cfg.n_layers:
                fail(f"query {body} launched the kernel {n} times, expected {cfg.n_layers}")
            tail = ([index[i] for i in body["items"]] if "items" in body
                    else deployed.histories[body["user"]])[-cfg.max_len:]
            black = [index[i] for i in body.get("blackList", [])]
            served = [index[s["item"]] for s in scores]
            if set(served) & set(tail + black):
                fail(f"query {body} served a history or black-listed item")
            ref = _reference_logits(deployed, tail, black)
            k = min(10, body["num"])
            ref_top = torch.topk(ref, k).indices.tolist()
            kth = ref[ref_top[-1]].item()
            served_top = served[:k]
            score_err = max(abs(s["score"] - ref[index[s["item"]]].item())
                            for s in scores[:k])
            swapped = set(served_top) - set(ref_top)
            worst_swap = min((ref[i].item() - kth for i in swapped), default=0.0)
            log(f"[serve] {json.dumps(body)[:60]}...: launches={n} "
                f"top{k}_same_set={not swapped} max_score_err={score_err:.4f} "
                f"worst_swap={worst_swap:.4f} rtt_ms={ms:.2f}")
            if score_err > SCORE_TOL or worst_swap < -SCORE_TOL:
                fail(f"served top-{k} disagrees with the plain-attention model for {body}")
        log(f"[serve] {len(queries)} queries, launches={launches} "
            f"({launches / len(queries):g} per query), http_p50_ms={statistics.median(rtts):.3f} "
            f"http_min_ms={min(rtts):.3f} http_max_ms={max(rtts):.3f}")
        return launches
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(model_dir, ignore_errors=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    max_abs_err = phase_kernel_vs_plain()
    times = phase_times()
    launches = phase_serving()
    if launches == 0:
        fail("the serving path never launched the flash_attention kernel")
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "design": "cuda-wgmma",
        "kv_tile": KV_TILE,
        "source": "predictionio_tpu_torch/csrc/flash_attention.cu",
        "replaces": "predictionio_tpu/ops/pallas_attention.py:78",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **times,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
