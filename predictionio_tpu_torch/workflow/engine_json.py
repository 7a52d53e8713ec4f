"""engine.json variant loading (port of the JAX package's
``workflow/engine_json.py``; the port reads no ``meshConf``)."""

from __future__ import annotations

import json
import os
from typing import Any


def read_variant(path: str) -> dict[str, Any]:
    """The parsed variant file, ``{}`` when it is absent
    (``json.JSONDecodeError`` when it is not JSON)."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_variant(path: str = "engine.json", engine_factory: str = "") -> dict[str, Any]:
    """The variant of a command that builds an engine: the file must
    exist unless ``engine_factory`` is given, which then replaces its
    "engineFactory"; one of the two must name the factory."""
    if not engine_factory and not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found. An engine project needs an engine.json "
            "(engineFactory + component params).")
    variant = read_variant(path)
    if engine_factory:
        variant["engineFactory"] = engine_factory
    if "engineFactory" not in variant:
        raise ValueError(f"{path} is missing required key 'engineFactory'")
    return variant
