"""Environment-overridable frozen-dataclass defaults (a copy of the JAX
package's ``utils/envcfg.py``): ``PIO_SERVING_*`` and ``PIO_ONLINE_*``
in ``workflow/deploy.py``, ``PIO_FLEET_*`` in ``fleet/supervisor.py``.

A field reads ``<PREFIX><KEY>`` when the config is BUILT (never at
import), casts it, and falls back to the coded default with a warning
when the value is malformed, instead of failing the server at config
time.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable

logger = logging.getLogger(__name__)


def env_default(prefix: str, key: str, default: Any,
                cast: Callable[[str], Any]) -> Any:
    """``<prefix><key>`` from the environment, cast; the coded default
    on absence or a malformed value (warned, never fatal)."""
    raw = os.environ.get(f"{prefix}{key}")
    if raw is None:
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError):
        logger.warning("ignoring malformed %s%s=%r (using %r)",
                       prefix, key, raw, default)
        return default


def env_field(prefix: str, key: str, default: Any,
              cast: Callable[[str], Any]):
    """A frozen-dataclass field whose default reads
    ``<prefix><key>`` at construction time."""
    return dataclasses.field(
        default_factory=lambda: env_default(prefix, key, default, cast))
