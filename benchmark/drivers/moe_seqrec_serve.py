"""Batch serving of the sessionrec engine with the MoE model kind
(``models/moe_seqrec.py``): a closed loop of one caller handing batches
of user queries back to back to ``DeployedEngine.query_batch``, as
``seqrec_serve.py`` does for the SASRec kind.

Set-up builds the deployed engine as ``load_deployed_engine`` would hand
it to the server: the template's engine, its algorithm and serving
classes, and a ``SeqRecEngineModel`` over a ``MoESeqRecConfig`` of the
cell's configuration, with the seeded bf16 weights and histories. It
warms the cell's one batch shape, then measures.

End to end: ``queries_per_s`` and ``query_p95_ms``, as ``seqrec_serve``
defines them.

Facts for the per-layer readers: the window's seconds, each batch's host
span and real lengths, and ``moe_routed``, the (layer, expert) pairs the
program's own counter (``pio_moe_routed_pairs_total``, which the served
engine model exports at scrape time through ``metric_families()``, read
before and after the window, outside it) counted in the window.

The check, after the window and with the program's state freed: every
answer is well formed, and for a sample of answered queries drawn from
the seed, with the longest history answered among them, each served
item's score under the plain reference (``reference/moe_seqrec.py``,
float32, the same bf16 weight values upcast at each use) lies below the reference's
score of the same rank by a query's gap (``seqrec_serve.rank_gap``).
Two readings of the sample's gaps are judged: their median
(``rank_gap_median``) and their largest (``rank_gap``). A position whose
top-8 experts change under bf16 rounding moves by a whole expert's
output, so one query in a sample of 32 can sit far from the reference
while the rest agree closely: the median reads the precision the
program computes in, the largest a query answered from the wrong
history or state.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np

from benchmark.drivers.seqrec_serve import _malformed, rank_gap, sample_queries
from benchmark.harness import traffic as tr
from benchmark.harness.runner import Outcome, RunSpec, log
from benchmark.inputs import moe_seqrec as inputs
from benchmark.reference import moe_seqrec as reference
from benchmark.roofline.peaks import DEFAULT_KIND, peaks_for


def _engine(cfg: dict, weights: dict, histories: list, device):
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models import moe_seqrec
    from predictionio_tpu_torch.templates import sessionrec
    from predictionio_tpu_torch.utils.bimap import BiMap
    from predictionio_tpu_torch.workflow.deploy import DeployedEngine

    model = sessionrec.SeqRecEngineModel(
        params=weights,
        cfg=moe_seqrec.MoESeqRecConfig.from_json(cfg),
        item_index=BiMap({str(i): i for i in range(1, cfg["vocab_size"])}),
        histories={inputs.user_name(u): h.tolist() for u, h in enumerate(histories)},
        device=device,
    )
    engine = sessionrec.engine_factory()
    params = EngineParams.of(algorithms=[("seqrec", sessionrec.AlgorithmParams())])
    _, _, algorithms, serving = engine.make_components(params)
    return (DeployedEngine(engine, "benchmark", algorithms, serving, [model], device),
            sessionrec.Query)


def routed_pairs(deployed) -> np.ndarray | None:
    """(layers, experts) pairs dispatched so far by the deployed MoE
    model, from the counter it exports at scrape time; None where the
    program has no such counter."""
    fams = {m.name: m for model in deployed.models
            for m in getattr(model, "metric_families", lambda: [])()}
    fam = fams.get("pio_moe_routed_pairs_total")
    if fam is None or not fam.samples:
        return None
    layers = 1 + max(int(labels["layer"]) for labels, _ in fam.samples)
    experts = 1 + max(int(labels["expert"]) for labels, _ in fam.samples)
    out = np.zeros((layers, experts))
    for labels, value in fam.samples:
        out[int(labels["layer"]), int(labels["expert"])] = value
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run(spec: RunSpec) -> Outcome:
    import torch

    from predictionio_tpu_torch.models import moe_seqrec  # noqa: F401  (fails at once without it)

    cfg, mix = spec.cell.config, spec.cell.traffic
    dev = spec.device
    weights = inputs.make_weights(cfg, spec.seed, dev)
    histories = inputs.make_histories(mix, cfg, spec.seed)
    log(spec, "weights and histories made")
    deployed, Query = _engine(cfg, weights, histories, dev)
    del weights
    log(spec, "engine built")
    env = {**cfg, "users": mix["users"]}
    warm = tr.batches(mix["queries"], env, tr.rng(spec.seed, "warmup"))
    num = int(mix["num"])
    for _ in range(int(mix["warmup_batches"])):
        deployed.query_batch([Query(user=inputs.user_name(u), num=num) for u in next(warm)])
    _sync(dev)
    setup_s = time.perf_counter() - spec.started
    log(spec, "warmed up; window opens")

    stream = tr.batches(mix["queries"], env, tr.rng(spec.seed, "queries"))
    done = []              # (start, end, users, answers or None)
    failed = 0
    routed_before = routed_pairs(deployed)
    with spec.trace:
        first = time.perf_counter()
        deadline = first + spec.seconds
        while not done or time.perf_counter() < deadline:
            users = next(stream)
            queries = [Query(user=inputs.user_name(u), num=num) for u in users]
            t0 = time.perf_counter()
            with spec.trace.span("query_batch"):
                try:
                    answers = deployed.query_batch(queries)
                except Exception:        # a failed batch counts, and the run goes on
                    traceback.print_exc(file=sys.stderr)
                    answers = None
            done.append((t0, time.perf_counter(), users, answers))
            failed += len(users) if answers is None else 0
        last = done[-1][1]
    window_s = last - first
    routed_after = routed_pairs(deployed)
    log(spec, f"window closed: {len(done)} batches in {window_s:.3f} s")
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del deployed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    attempted = sum(len(u) for _, _, u, _ in done)
    lat_ms = np.repeat([(t1 - t0) * 1e3 for t0, t1, _, _ in done],
                       [len(u) for _, _, u, _ in done])
    lengths = np.asarray([min(len(h), cfg["max_len"]) for h in histories])

    malformed = 0
    answered = []
    own: dict[int, set] = {}
    for b, (_, _, users, answers) in enumerate(done):
        if answers is None:
            continue
        for j, (u, a) in enumerate(zip(users, answers)):
            if u not in own:
                own[u] = set(histories[u][-cfg["max_len"]:].tolist())
            if _malformed(a, own[u], num, cfg["vocab_size"]):
                malformed += 1
            else:
                answered.append((b, j))
    histories = inputs.make_histories(mix, cfg, spec.seed)
    weights = inputs.make_weights(cfg, spec.seed, dev)
    gaps = []
    if answered:
        picked = sample_queries(answered, lambda bj: lengths[done[bj[0]][2][bj[1]]],
                                int(mix["check"]["sample"]), spec.seed)
        with torch.inference_mode():
            for b, j in picked:
                served = [int(s.item) for s in done[b][3][j].item_scores]
                ref = reference.scores(weights, cfg, histories[done[b][2][j]])
                gaps.append(rank_gap(ref, served))
    gap = max(gaps, default=float("nan"))
    gap_median = float(np.median(gaps)) if gaps else float("nan")
    log(spec, f"checked {len(answered)} answers, {malformed} malformed; rank_gap {gap}, "
              f"median {gap_median}; sample's gaps {sorted(round(g, 4) for g in gaps)}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else DEFAULT_KIND
    facts = {
        "window_s": window_s,
        "batch_ms": [(t1 - t0) * 1e3 for t0, t1, _, _ in done],
        "batch_lengths": [lengths[u] for _, _, u, _ in done],
        "padded_len": cfg["max_len"],
    }
    if routed_before is not None and routed_after is not None:
        facts["moe_routed"] = (routed_after - routed_before).tolist()
    return Outcome(
        attempted=attempted,
        failed=failed,
        end_to_end={
            "setup_s": setup_s,
            "queries_per_s": (attempted - failed) / window_s,
            "query_p95_ms": float(np.percentile(lat_ms, 95)),
        },
        facts=facts,
        readings={"rank_gap_median": gap_median, "rank_gap": gap, "malformed": malformed,
                  "failed": failed},
        memory_peak_bytes=memory_peak,
        config=cfg,
        peaks=peaks_for(kind),
    )
