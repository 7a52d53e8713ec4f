"""The controls' readings for the MoE sessionrec cell, from which, with
the program's readings (``tools/calibrate.py --seeds``, which runs any
cell's driver), its ``rank_gap_median`` and ``rank_gap`` limits are set:
for each of ``--control-seeds``, the plain reference
(``reference/moe_seqrec.py``) put in the program's place with its
product operands rounded to float8 e4m3 (``reference/lowp.py``), the
precision below the configuration's bfloat16, read by the same numbers
against the float reference, over the sample a run draws from the seed's
first ``--batches`` batches; and, as a yardstick of what the stated
precision itself gives, the same with the operands rounded to bfloat16.

    python3 benchmark/tools/calibrate_moe_seqrec.py \\
        --workload sessionrec-mellum2-s8192.serve-long-b16 --control-seeds 1 2 3

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


def _bf16(x):
    import torch

    return x.to(torch.bfloat16).to(x.dtype)


def control(cell, seed: int, device, batches: int) -> dict:
    """The fp8 and bf16 controls' per-query gaps over the sample of
    ``seed``."""
    import torch

    from benchmark.drivers.seqrec_serve import rank_gap, sample_queries
    from benchmark.harness import traffic as tr
    from benchmark.inputs import moe_seqrec as inputs
    from benchmark.reference import lowp
    from benchmark.reference import moe_seqrec as reference

    cfg, mix = cell.config, cell.traffic
    weights = inputs.make_weights(cfg, seed, device)
    histories = inputs.make_histories(mix, cfg, seed)
    stream = tr.batches(mix["queries"], {**cfg, "users": mix["users"]},
                        tr.rng(seed, "queries"))
    users = [next(stream) for _ in range(batches)]
    pairs = [(b, j) for b in range(batches) for j in range(len(users[b]))]
    picked = sample_queries(pairs, lambda bj: len(histories[users[bj[0]][bj[1]]]),
                            int(mix["check"]["sample"]), seed)
    gaps: dict[str, list] = {"fp8": [], "bf16": []}
    with torch.inference_mode():
        for b, j in picked:
            h = histories[users[b][j]]
            ref = reference.scores(weights, cfg, h)
            for name, rounding in (("fp8", lowp.fp8), ("bf16", _bf16)):
                low = reference.scores(weights, cfg, h, rounding=rounding)
                served = torch.topk(low, int(mix["num"])).indices.tolist()
                gaps[name].append(rank_gap(ref, served))
    return gaps


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=40)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import guard

    guard.pin_caches(ROOT)
    import torch

    from benchmark.harness.manifest import load_cell

    if not torch.cuda.is_available():
        print("calibration reads the card; none found", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    import statistics

    readings = []
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        gaps = control(cell, seed, device, args.batches)
        readings.append({f"{name}.{stat}": fn(g) for name, g in gaps.items()
                         for stat, fn in (("rank_gap", max),
                                          ("rank_gap_median", statistics.median))})
        _emit(kind="control", seed=seed, readings=readings[-1],
              gaps={k: sorted(round(x, 4) for x in g) for k, g in gaps.items()},
              seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    _emit(kind="summary", card=torch.cuda.get_device_name(device),
          **{f"{k}.min": min(r[k] for r in readings) for k in readings[0]},
          **{f"{k}.max": max(r[k] for r in readings) for k in readings[0]})
    guard.check_no_jax()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
