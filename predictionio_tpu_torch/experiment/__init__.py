"""Experimentation: the parallel evaluation grid (``experiment/grid.py``:
``pio eval --parallel N`` / ``PIO_EVAL_PARALLEL``).

The JAX package's other two legs, the A/B ``ExperimentController`` and
``pio experiment``, are ROADMAP.md queue 1 item 23, with the router whose
``/metrics`` registers
:func:`~predictionio_tpu_torch.experiment.grid.eval_points_collector`.
"""

from predictionio_tpu_torch.experiment.grid import (
    GridPointResult,
    eval_point_counts,
    eval_points_collector,
    run_parallel_grid,
)

__all__ = [
    "GridPointResult",
    "eval_point_counts",
    "eval_points_collector",
    "run_parallel_grid",
]
