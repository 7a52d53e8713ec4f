"""Experimentation: the parallel evaluation grid (``experiment/grid.py``:
``pio eval --parallel N`` / ``PIO_EVAL_PARALLEL``).

The JAX package's other two legs, the A/B ``ExperimentController`` and
``pio experiment``, are ROADMAP.md queue 1 item 23; its
``eval_points_collector`` (``/metrics``) is item 12, and
:func:`~predictionio_tpu_torch.experiment.grid.eval_point_counts` reads
the same counts.
"""

from predictionio_tpu_torch.experiment.grid import (
    GridPointResult,
    eval_point_counts,
    run_parallel_grid,
)

__all__ = [
    "GridPointResult",
    "eval_point_counts",
    "run_parallel_grid",
]
