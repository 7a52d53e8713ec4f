"""Algorithm placement (port of the JAX package's
``controller/algorithm.py``; serving needs only the host-model kind).
"""

from __future__ import annotations

import abc

from predictionio_tpu_torch.controller.base import M, P, PD, Q, Algorithm


class HostModelAlgorithm(Algorithm[PD, M, Q, P], abc.ABC):
    """Device-trained model whose weights the host holds between
    requests and hands to the device for each predict: serving needs no
    mesh."""

    placement = "host_model"
