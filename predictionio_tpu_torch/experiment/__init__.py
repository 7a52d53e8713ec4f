"""Experimentation (a copy of the JAX package's ``experiment/``): the
parallel evaluation grid, the online A/B controller and its command.

- ``grid.py``: ``pio eval --parallel N`` / ``PIO_EVAL_PARALLEL`` forks
  the grid's points into short-lived eval workers;
- ``controller.py``: :class:`ExperimentController` (define → ramp →
  measure → promote|abort) splits the router's bare-path traffic across
  variant engines, scores them from routed outcomes and attributed
  conversions, and promotes the winner through the canary guardrails;
- ``cli.py``: ``pio experiment start|status|conversions`` against a
  running ``pio router``.

Importing this package loads no torch: the router imports the
controller and registers :func:`eval_points_collector`.
"""

from predictionio_tpu_torch.experiment.controller import (
    ExperimentConfig,
    ExperimentController,
    VariantSpec,
)
from predictionio_tpu_torch.experiment.grid import (
    GridPointResult,
    eval_point_counts,
    eval_points_collector,
    run_parallel_grid,
)

__all__ = [
    "ExperimentConfig",
    "ExperimentController",
    "GridPointResult",
    "VariantSpec",
    "eval_point_counts",
    "eval_points_collector",
    "run_parallel_grid",
]
