"""Algorithm placement (port of the JAX package's
``controller/algorithm.py``): where a model lives between training and
serving.

- :class:`LocalAlgorithm` trains and predicts on the host; its model is
  host memory.
- :class:`HostModelAlgorithm` trains on the device; the host holds the
  finished weights between requests and hands them to the device for
  each predict.
- :class:`ShardedAlgorithm` keeps its model on the device between
  training and serving, sharded over the context's mesh when it trains
  with one (``parallel/mesh.py``; the ALS templates' ``shardFactors``).
  The contract is the JAX package's (the reference's PAlgorithm):
  ``batch_predict`` must be overridden with a device-side
  implementation, and models are not pickled by default
  (``make_persistent_model`` returns None: retrain on deploy) unless the
  algorithm saves them itself, as the ALS templates do.
"""

from __future__ import annotations

import abc
from typing import Any, Sequence

from predictionio_tpu_torch.controller.base import M, P, PD, Q, Algorithm


class LocalAlgorithm(Algorithm[PD, M, Q, P], abc.ABC):
    """Host-only algorithm; never touches the device."""

    placement = "local"


class HostModelAlgorithm(Algorithm[PD, M, Q, P], abc.ABC):
    """Device-trained model whose weights the host holds between
    requests and hands to the device for each predict: serving needs no
    mesh."""

    placement = "host_model"


class ShardedAlgorithm(Algorithm[PD, M, Q, P], abc.ABC):
    """Model stays on the device, sharded over the mesh when trained on
    one, between training and serving."""

    placement = "sharded"

    def batch_predict(self, model: M, queries: Sequence[tuple[int, Q]]) -> Sequence[tuple[int, P]]:
        raise NotImplementedError(
            f"{type(self).__name__} is a ShardedAlgorithm and must override "
            "batch_predict with a device-side implementation")

    def make_persistent_model(self, ctx: Any, model: M):
        """Default for device-resident models: persist nothing and retrain
        on deploy. Algorithms that save checkpoints override."""
        return None
