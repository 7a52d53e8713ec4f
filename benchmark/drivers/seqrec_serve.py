"""Batch serving of the sessionrec engine: a closed loop of one caller
handing batches of user queries back to back to
``DeployedEngine.query_batch``, the entry the engine server calls.

Set-up builds the deployed engine as ``load_deployed_engine`` would hand
it to the server: the template's engine, its algorithm and serving
classes, and a ``SeqRecEngineModel`` over the seeded weights and
histories. It warms the cell's one batch shape, then measures.

End to end: ``queries_per_s`` (every query answered in the window over
the window's seconds, the window running from the first batch's start
to the end of the last batch started before ``--seconds`` was up) and
``query_p95_ms`` (a query's latency runs from its batch's hand-over to
its answer on the host).

The check, after the window and with the program's state freed: every
answer is well formed (``num`` distinct items, known ids, none of PAD or
the session's own items), and for a sample of answered queries drawn
from the seed, with the longest history answered among them, each served
item's score under the plain reference (``reference/seqrec.py``) lies
below the reference's score of the same rank by at most the limit
(``rank_gap``).
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np

from benchmark.harness import traffic as tr
from benchmark.harness.runner import Outcome, RunSpec, log
from benchmark.inputs import seqrec as inputs
from benchmark.reference import seqrec as reference
from benchmark.roofline.peaks import DEFAULT_KIND, peaks_for


def _engine(cfg: dict, weights: dict, histories: list, device):
    import torch

    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models import seqrec
    from predictionio_tpu_torch.templates import sessionrec
    from predictionio_tpu_torch.utils.bimap import BiMap
    from predictionio_tpu_torch.workflow.deploy import DeployedEngine

    model = sessionrec.SeqRecEngineModel(
        params=weights,
        cfg=seqrec.SeqRecConfig(vocab=cfg["vocab"], max_len=cfg["max_len"],
                                d_model=cfg["d_model"], n_heads=cfg["n_heads"],
                                n_layers=cfg["n_layers"], mlp_mult=cfg["mlp_mult"],
                                dtype=getattr(torch, cfg["dtype"])),
        item_index=BiMap({str(i): i for i in range(1, cfg["vocab"])}),
        histories={inputs.user_name(u): h.tolist() for u, h in enumerate(histories)},
        device=device,
    )
    engine = sessionrec.engine_factory()
    params = EngineParams.of(algorithms=[("seqrec", sessionrec.AlgorithmParams())])
    _, _, algorithms, serving = engine.make_components(params)
    return (DeployedEngine(engine, "benchmark", algorithms, serving, [model], device),
            sessionrec.Query)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _malformed(answer, own: set, num: int, vocab: int) -> bool:
    """An answer that is not ``num`` distinct known items outside PAD and
    the session's own items ``own``."""
    try:
        items = [int(s.item) for s in answer.item_scores]
    except (AttributeError, TypeError, ValueError):
        return True
    return (len(items) != num or len(set(items)) != num
            or any(i < 1 or i >= vocab or i in own for i in items))


def rank_gap(ref_scores, served: list[int]) -> float:
    """The widest gap by which a served item's reference score lies below
    the reference's score of the same rank."""
    import torch

    ranked = torch.sort(ref_scores, descending=True).values[: len(served)]
    mine = ref_scores[torch.as_tensor(served, device=ref_scores.device)]
    return float((ranked - mine).max())


def sample_queries(answered: list[tuple[int, int]], length, count: int,
                   seed: int) -> list[tuple[int, int]]:
    """``count`` of the answered (batch, position) pairs drawn from the
    seed, with one of the longest histories answered among them
    (``length`` gives a pair's history length)."""
    gen = tr.rng(seed, "sample")
    pick = gen.choice(len(answered), size=min(count, len(answered)), replace=False)
    chosen = [answered[i] for i in sorted(pick)]
    longest = max(answered, key=length)
    if longest not in chosen:
        chosen[-1] = longest
    return chosen


def run(spec: RunSpec) -> Outcome:
    import torch

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

    # the check: the reference gets the weights and histories made anew
    malformed = 0
    answered = []
    own: dict[int, set] = {}
    for b, (_, _, users, answers) in enumerate(done):
        if answers is None:
            continue
        for j, (u, a) in enumerate(zip(users, answers)):
            if u not in own:
                own[u] = set(histories[u][-cfg["max_len"]:].tolist())
            if _malformed(a, own[u], num, cfg["vocab"]):
                malformed += 1
            else:
                answered.append((b, j))
    histories = inputs.make_histories(mix, cfg, spec.seed)
    weights = inputs.make_weights(cfg, spec.seed, dev)
    gap = float("nan")
    if answered:
        gap = 0.0
        picked = sample_queries(answered, lambda bj: lengths[done[bj[0]][2][bj[1]]],
                                int(mix["check"]["sample"]), spec.seed)
        with torch.inference_mode():
            for b, j in picked:
                served = [int(s.item) for s in done[b][3][j].item_scores]
                ref = reference.scores(weights, cfg, histories[done[b][2][j]])
                gap = max(gap, rank_gap(ref, served))
    log(spec, f"checked {len(answered)} answers, {malformed} malformed; rank_gap {gap}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else DEFAULT_KIND
    return Outcome(
        attempted=attempted,
        failed=failed,
        end_to_end={
            "setup_s": setup_s,
            "queries_per_s": (attempted - failed) / window_s,
            "query_p95_ms": float(np.percentile(lat_ms, 95)),
        },
        facts={
            "window_s": window_s,
            "batch_ms": [(t1 - t0) * 1e3 for t0, t1, _, _ in done],
            "batch_lengths": [lengths[u] for _, _, u, _ in done],
            "padded_len": cfg["max_len"],
        },
        readings={"rank_gap": gap, "malformed": malformed, "failed": failed},
        memory_peak_bytes=memory_peak,
        config=cfg,
        peaks=peaks_for(kind),
    )
