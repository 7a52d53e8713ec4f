"""engine.json variant loading (port of the JAX package's
``workflow/engine_json.py``), and its ``meshConf``, the device-mesh axis
spec that training reads into ``WorkflowParams.mesh_conf``."""

from __future__ import annotations

import json
import logging
import os
from typing import Any

logger = logging.getLogger(__name__)


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


def mesh_conf_from_variant(variant: dict[str, Any]) -> dict[str, Any]:
    """The native "meshConf" key; a legacy "sparkConf" subtree from a
    ported reference engine.json is ignored with a logged note."""
    if "sparkConf" in variant and "meshConf" not in variant:
        logger.warning(
            "engine.json has a 'sparkConf' subtree, which this framework does "
            "not use; configure the device mesh via 'meshConf' "
            "(e.g. {\"axes\": {\"data\": 4, \"model\": 2}})")
    return dict(variant.get("meshConf", {}))
