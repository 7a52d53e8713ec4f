"""The built-in rule suite — importing this package registers every
rule with the framework registry (analysis.core)
(a copy of the JAX package's ``analysis/rules/__init__.py``)."""

from __future__ import annotations

import predictionio_tpu_torch.analysis.rules.resilience  # noqa: F401
import predictionio_tpu_torch.analysis.rules.jit_purity  # noqa: F401
import predictionio_tpu_torch.analysis.rules.host_sync  # noqa: F401
import predictionio_tpu_torch.analysis.rules.dtype  # noqa: F401
import predictionio_tpu_torch.analysis.rules.blocking_io  # noqa: F401
import predictionio_tpu_torch.analysis.rules.locks  # noqa: F401
import predictionio_tpu_torch.analysis.rules.shared_state_race  # noqa: F401
import predictionio_tpu_torch.analysis.rules.lock_order  # noqa: F401
import predictionio_tpu_torch.analysis.rules.jit_recompile  # noqa: F401
