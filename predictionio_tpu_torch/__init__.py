"""PyTorch/CUDA port of predictionio_tpu for one NVIDIA H100.

The JAX package ``predictionio_tpu`` stays the reference; this package
mirrors its layout and module names so each counterpart is easy to
find, and imports nothing of it (nor of JAX). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; asking for CUDA on
a machine without a card raises (utils/device.py).

Ported so far: sessionrec serving — ``templates/sessionrec.py`` →
``models/seqrec.py`` → ``ops/flash_attention.py``, whose CUDA kernel
(``csrc/flash_attention.cu``) replaces the JAX package's Pallas
``_flash_kernel`` — and sessionrec training: events in the memory event
store (``storage/``, ``data/store.py``) → ``workflow/train.run_train`` →
``controller/engine.Engine.train`` → ``models/seqrec.train`` (Adam over
``next_item_loss``, attention through the differentiable
``ops/attention.py``) → a model directory that ``workflow/deploy.py``
serves. Training launches no hand-written kernel.

The ALS recommendation engine: ``templates/recommendation.py`` →
``ops/als.als_train`` (the fused ladder layout, an eager loop over
device-resident slabs) → ``models/als.ALSModel`` (brute-force masked
top-k, ``ops/topk.py``), saved with the npz checkpoint of
``utils/checkpoint.py``. The JAX package runs this path as XLA programs;
the port runs it as torch code, with no hand-written kernel.

Both deploy behind ``api/engine_server.py``, the JAX package's serving
layer: the micro-batcher (``serving/batcher.py``, one
``DeployedEngine.query_batch`` per batch), the result cache
(``serving/result_cache.py``), plugins, ``/reload``, ``/readyz``,
``/stats.json`` and request deadlines.
"""

__version__ = "0.1.0"

from predictionio_tpu_torch.core.datamap import DataMap, PropertyMap
from predictionio_tpu_torch.core.event import Event, EventValidation

__all__ = [
    "DataMap",
    "PropertyMap",
    "Event",
    "EventValidation",
    "__version__",
]
