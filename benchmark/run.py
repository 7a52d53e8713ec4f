"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``. The run
makes its inputs from ``--seed``, sets up the PyTorch port and warms the
cell's shapes (``setup_s``), measures for ``--seconds``, checks what the
window produced against the plain reference, and prints one JSON object
as the last line of standard output, with each compared number and its
limit as the last lines of standard error. ``--trace 1`` measures the
window under ``torch.profiler`` and reports the cell's per-layer metrics
in place of its end-to-end ones. With no CUDA card, with fewer cards
than the cell asks for, or without the port beside the benchmark, the
run exits with a non-zero code and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str]) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import guard

    guard.pin_caches(ROOT)
    from benchmark.harness.manifest import load_cell
    from benchmark.harness.runner import RunSpec, execute
    from benchmark.harness.trace import WindowTrace

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    try:
        import predictionio_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the PyTorch port is not beside the benchmark: {exc}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    spec = RunSpec(cell=cell, seed=args.seed, seconds=args.seconds,
                   trace=WindowTrace(bool(args.trace)), device=device, started=STARTED)
    try:
        line = execute(spec, torch.cuda.get_device_name(device))
    except guard.ForbiddenImport as exc:
        print(str(exc), file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
