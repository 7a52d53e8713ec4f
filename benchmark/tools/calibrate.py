"""The readings that a cell's limits are set from, at the cell's own size
on the card, many seeds in one process:

- the program's: a short run of the cell (its window, sample and check
  as every run makes them) for each of ``--seeds``;
- the control's, for each of ``--control-seeds``: the plain reference
  put in the program's place, its product operands rounded to float8
  e4m3, the precision below the configuration's bfloat16, read by the
  same number against the float reference;
- for the ALS cell, the training faults too: one iteration left out (the
  last step returns its state unchanged) and half of the ratings left
  out.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 --seconds 2

Prints one JSON line per reading and a summary line; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def serve_control(cell, seed: int, device, batches: int) -> float:
    """The fp8 control's ``rank_gap`` over the sample a run draws from
    the seed's first ``batches`` batches."""
    import torch

    from benchmark.drivers.seqrec_serve import rank_gap, sample_queries
    from benchmark.harness import traffic as tr
    from benchmark.inputs import seqrec as inputs
    from benchmark.reference import lowp
    from benchmark.reference import seqrec as reference

    cfg, mix = cell.config, cell.traffic
    weights = inputs.make_weights(cfg, seed, device)
    histories = inputs.make_histories(mix, cfg, seed)
    stream = tr.batches(mix["queries"], {**cfg, "users": mix["users"]},
                        tr.rng(seed, "queries"))
    users = [next(stream) for _ in range(batches)]
    pairs = [(b, j) for b in range(batches) for j in range(len(users[b]))]
    picked = sample_queries(pairs, lambda bj: len(histories[users[bj[0]][bj[1]]]),
                            int(mix["check"]["sample"]), seed)
    gap = 0.0
    with torch.inference_mode():
        for b, j in picked:
            h = histories[users[b][j]]
            ref = reference.scores(weights, cfg, h)
            low = reference.scores(weights, cfg, h, rounding=lowp.fp8)
            served = torch.topk(low, int(mix["num"])).indices.tolist()
            gap = max(gap, rank_gap(ref, served))
    return gap


def als_control(cell, seed: int, device) -> dict:
    """The fp8 control's and the training faults' ``factor_gap``."""
    import numpy as np
    import torch

    from benchmark.drivers import als_train as driver
    from benchmark.inputs import als as inputs
    from benchmark.reference import als as reference
    from benchmark.reference import lowp
    from predictionio_tpu_torch.workflow.context import EngineContext

    cfg, mix = cell.config, cell.traffic
    it = int(mix["iterations"])
    rows, cols, vals = inputs.make_ratings(mix, cfg, seed)
    item_seed = inputs.item_seed(seed)
    item0 = reference.starting_items(cfg["items"], cfg["rank"], item_seed)
    out = {}
    with torch.inference_mode():
        ref_u, ref_i = reference.train(rows, cols, vals, cfg["users"], cfg["items"], item0,
                                       it, cfg["lambda"], device)

        def gap(u, i) -> float:
            return max(reference.worst_row_gap(u, ref_u), reference.worst_row_gap(i, ref_i))

        low_u, low_i = reference.train(rows, cols, vals, cfg["users"], cfg["items"], item0,
                                       it, cfg["lambda"], device, rounding=lowp.fp8)
        out["control_fp8"] = gap(low_u, low_i)
        del low_u, low_i
    ctx = EngineContext(device=device, devices=[device])
    pd = driver.prepared_data(rows, cols, vals, cfg)
    model = driver.algorithm(cfg, it - 1, item_seed).train(ctx, pd)
    out["fault_last_step_unchanged"] = gap(model.user_factors, model.item_factors)
    keep = np.arange(len(rows)) % 2 == 0
    half = driver.prepared_data(rows[keep], cols[keep], vals[keep], cfg)
    model = driver.algorithm(cfg, it, item_seed).train(ctx, half)
    out["fault_half_ratings"] = gap(model.user_factors, model.item_factors)
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--batches", type=int, default=40,
                    help="serving: batches of the stream the control samples from")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import guard

    guard.pin_caches(ROOT)
    import torch

    from benchmark.harness.manifest import load_cell, load_module
    from benchmark.harness.runner import RunSpec
    from benchmark.harness.trace import WindowTrace

    if not torch.cuda.is_available():
        print("calibration reads the card; none found", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    driver = load_module("drivers", cell.traffic["driver"])
    program = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = driver.run(RunSpec(cell=cell, seed=seed, seconds=args.seconds,
                                 trace=WindowTrace(False), device=device, started=t0))
        program.append(out.readings)
        _emit(kind="program", seed=seed, readings=out.readings, attempted=out.attempted,
              end_to_end=out.end_to_end, seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    controls = []
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        if cell.config["family"] == "als":
            reading = als_control(cell, seed, device)
        else:
            reading = {"control_fp8": serve_control(cell, seed, device, args.batches)}
        controls.append(reading)
        _emit(kind="control", seed=seed, readings=reading, seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    summary = {}
    for name in (program[0] if program else {}):
        summary[f"program.{name}.max"] = max(r[name] for r in program)
    for name in (controls[0] if controls else {}):
        summary[f"{name}.min"] = min(r[name] for r in controls)
    _emit(kind="summary", card=torch.cuda.get_device_name(device), **summary)
    guard.check_no_jax()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
