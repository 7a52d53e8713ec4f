"""The MoE sessionrec cell on the CPU at a tiny size of its own (the
cell's driver, reference, readers and limits; ``bench_tiny.py`` holds
the other cells): a short run is correct with a sound line, traced and
not; the reference copy agrees with the port's; the roofline counts and
the readers; and the fp8 control misses what the program reads."""

from __future__ import annotations

import dataclasses
import math
import time

import bench_tiny
import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.harness.runner import Outcome, RunSpec, execute
from benchmark.harness.trace import TraceSummary, WindowTrace
from benchmark.inputs import moe_seqrec as inputs
from benchmark.reference import lowp
from benchmark.reference import moe_seqrec as reference
from benchmark.roofline import moe_seqrec as roof
from benchmark.roofline.peaks import DEFAULT_KIND, peaks_for

CELL = "sessionrec-mellum2-s8192.serve-long-b16"
READERS = ("mfu.serve-long", "flash_attention_roofline.gqa-window", "moe_experts_roofline",
           "idle.moe.serve-long", "moe.load_max.serve-long")


def tiny_cell():
    """The cell at a CPU size, run in float32 (its bf16 weight values
    widened): at 8 experts of width 32 bf16 rounding flips a token's
    top-2 often enough to move a tiny model's answer by more than the
    cell's limit, which is set at the published widths on the card; in
    f32 the program must answer as the reference does."""
    cell = mf.load_cell(CELL)
    layer_types = ["sliding_attention"] * 3 + ["full_attention"]
    rope = dict(cell.config["rope_parameters"])
    rope["full_attention"] = dict(rope["full_attention"], original_max_position_embeddings=64)
    cfg = dict(cell.config, vocab_size=301, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, layer_types=layer_types,
               mlp_layer_types=["sparse"] * 4, sliding_window=8, num_experts=8,
               num_experts_per_tok=2, moe_intermediate_size=32, num_hidden_layers=4,
               max_len=64, rope_parameters=rope, dtype="float32")
    mix = dict(cell.traffic, users=48,
               history={"length": {"dist": "log_uniform_int", "low": 4, "high": "$max_len",
                                   "stratified": True},
                        "items": {"dist": "power_int", "n": 300, "exponent": 1.8, "offset": 1}},
               queries={"batch": 4, "keys": {"dist": "shuffled_cycle", "low": 0, "high": 47}},
               warmup_batches=1, check={"sample": 6})
    return dataclasses.replace(cell, config=cfg, traffic=mix)


def _run(trace: bool, seed: int = 2**31 + 21) -> dict:
    spec = RunSpec(cell=tiny_cell(), seed=seed, seconds=0.3, trace=WindowTrace(trace),
                   device=torch.device("cpu"), started=time.perf_counter())
    return execute(spec, "cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct_with_a_sound_line(trace):
    line = _run(trace)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    if trace:
        got = set(line["metrics"])
        # no card on the CPU: the device-trace shares have nothing to read
        assert {"mfu.serve-long", "moe.load_max.serve-long"} <= got
        assert got <= set(READERS)
        assert line["metrics"]["moe.load_max.serve-long"]["value"] >= 1.0
    else:
        assert set(line["metrics"]) == {"setup_s", "queries_per_s", "query_p95_ms"}


def test_the_reference_copy_agrees_with_the_ports():
    from predictionio_tpu_torch.models import moe_seqrec_reference as port_ref

    cfg = tiny_cell().config
    w = inputs.make_weights(cfg, 5, torch.device("cpu"))
    hist = list(range(1, 40))
    a = reference.last_logits(w, cfg, hist)
    b = port_ref.last_logits(w, cfg, hist)
    assert torch.equal(a, b)
    s = reference.scores(w, cfg, hist)
    assert s[0] == -math.inf and torch.all(s[torch.tensor(hist)] == -math.inf)


def test_weights_are_bf16_values_and_the_reference_upcasts_them():
    cfg = tiny_cell().config
    w = inputs.make_weights(cfg, 2**31 + 1, torch.device("cpu"))
    assert all(v.dtype == torch.bfloat16 for v in w.values())
    from predictionio_tpu_torch.models import moe_seqrec

    shapes = dict(moe_seqrec.weight_shapes(moe_seqrec.MoESeqRecConfig.from_json(cfg)))
    assert {k: tuple(v.shape) for k, v in w.items()} == shapes
    # the reference computes in f32 whether it is handed the bf16 tensors
    # or their f32 copies
    hist = list(range(3, 50))
    assert torch.equal(reference.last_logits(w, cfg, hist),
                       reference.last_logits({k: v.float() for k, v in w.items()}, cfg, hist))


def test_the_fp8_control_reads_above_the_program():
    cfg = tiny_cell().config
    w = inputs.make_weights(cfg, 9, torch.device("cpu"))
    from benchmark.drivers.seqrec_serve import rank_gap

    gaps = []
    for hist in ([3, 5, 8] * 13, list(range(100, 160))):
        ref = reference.scores(w, cfg, hist)
        low = reference.scores(w, cfg, hist, rounding=lowp.fp8)
        gaps.append(rank_gap(ref, torch.topk(low, 10).indices.tolist()))
    assert max(gaps) > 0.05


def test_roofline_counts():
    cfg = dict(tiny_cell().config, sliding_window=3)
    assert roof.pairs("sliding_attention", 5, 3) == 1 + 2 + 3 + 3 + 3
    assert roof.pairs("full_attention", 5, 3) == 15
    flops, nbytes = roof.flash_launch(cfg, "sliding_attention", [5, 2, 99])
    pairs = 12 + 3 + (6 + 3 * (64 - 3))       # 99 is capped at max_len 64
    assert flops == 4 * 16 * 4 * pairs
    assert nbytes == 2 * (2 * 4 + 2 * 2) * 16 * (5 + 2 + 64) + 4 * (5 + 2 + 64)
    eflops, ebytes = roof.experts_layer(cfg, [5, 3])
    assert eflops == 6 * 64 * 32 * 2 * 8
    assert ebytes == 2 * (8 * 3 * 64 * 32 + 16 * (64 + 3 * 32 + 64))
    per_token = 2 * 64 * 8 * 16 + 2 * 64 * 64 + 2 * 64 * 8 + 2 * 6 * 64 * 32
    want = 4 * 5 * per_token + 4 * 16 * 4 * (3 * 12 + 15) + 2 * 64 * 301
    assert roof.query_forward_flops(cfg, 5) == want


def test_readers_on_a_hand_built_trace():
    cfg = tiny_cell().config
    peaks = peaks_for(DEFAULT_KIND)
    gaps = {"bench.query_batch: seqrec.moe.route": 0.5, "bench.query_batch: seqrec.moe.experts":
            0.25, "bench.query_batch: seqrec.decode": 4.0, "gaps under 20 us": 1.0}
    events = [("flash_fwd_bf16_wgmma<128>", 0, 2_000_000),
              ("_ZN7cutlass13device_kernelIN2at4cuda6detail17GroupProblemShape", 0, 1_000_000),
              ("nvjet_tst_192x192", 0, 5_000_000)]
    outcome = Outcome(attempted=8, failed=0, end_to_end={},
                      facts={"window_s": 10.0, "batch_lengths": [[5, 64], [7, 7]],
                             "moe_routed": [[4, 2, 2, 0], [1, 1, 1, 1]]},
                      readings={}, memory_peak_bytes=0, config=cfg, peaks=peaks,
                      trace=TraceSummary(10.0, 5.0, 3, {}, gaps, events))

    def read(name):
        return mf.load_module("metrics", name).read(outcome)

    assert read("idle.moe.serve-long") == pytest.approx(100 * 0.75 / 10)
    assert read("moe.load_max.serve-long") == pytest.approx(2.0)
    lengths = [[5, 64], [7, 7]]
    flops = sum(roof.batch_forward_flops(cfg, b) for b in lengths)
    assert read("mfu.serve-long") == pytest.approx(100 * flops / 10 / peaks["bf16_flops"])
    least = sum(roof.least_s(roof.flash_launch(cfg, k, b), peaks)
                for b in lengths for k in cfg["layer_types"])
    assert read("flash_attention_roofline.gqa-window") == pytest.approx(100 * least / 2e-3)
    least = sum(roof.least_s(roof.experts_layer(cfg, b), peaks) for b in lengths) * 4
    assert read("moe_experts_roofline") == pytest.approx(100 * least / 1e-3)
    bare = dataclasses.replace(outcome, trace=None)
    assert all(mf.load_module("metrics", n).read(bare) is None for n in READERS)


def test_the_manifest_entries():
    manifest = mf.load_manifest()
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "queries_per_s"
    assert {"queries_per_s", "query_p95_ms"} <= {
        m["name"] for m in manifest["end_to_end"] if CELL in m.get("workloads", [CELL])}
    cell = bench_tiny.load_cell(CELL)
    assert cell.chips == 1 and cell.config["num_hidden_layers"] == 28
    assert cell.limits["malformed"] == 0 and cell.limits["failed"] == 0
