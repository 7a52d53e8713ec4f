"""Spec-string resolution: "pkg.module.Obj" / "pkg.module:Obj" → object
(a copy of the JAX package's ``utils/reflection.py``).

The one replacement for the reference's class-name reflection helpers:
engine factories, evaluations, params generators and persistent models
all resolve through here.
"""

from __future__ import annotations

import importlib
from typing import Any


def resolve_attr(spec: str) -> Any:
    """Import the module named by ``spec`` and walk the attribute path.

    Accepts "pkg.module:attr.path" (explicit module/attr split) or
    "pkg.module.attr" (split at the last dot).
    """
    if ":" in spec:
        module_name, attr = spec.split(":", 1)
    else:
        module_name, _, attr = spec.rpartition(".")
        if not module_name:
            raise ValueError(f"invalid object spec {spec!r}")
    obj: Any = importlib.import_module(module_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj
