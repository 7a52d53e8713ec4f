"""Parameter types for DASE components (port of the JAX package's
``controller/params.py``, which holds no device code; copied so the
port imports nothing of that package).

Params classes are plain frozen dataclasses; the JSON in engine.json
binds to them by field name.
"""

from __future__ import annotations

import dataclasses
import keyword
import re
from typing import Any, Sequence, Type, TypeVar

P = TypeVar("P")


@dataclasses.dataclass(frozen=True)
class Params:
    """Marker base for component parameter classes. Subclasses are
    frozen dataclasses."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """Parameters of a component that takes none."""


def _snake(name: str) -> str:
    """camelCase -> snake_case; appends "_" when the result is a Python
    keyword ("lambda" -> "lambda_")."""
    out = re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name).lower()
    return out + "_" if keyword.iskeyword(out) else out


def params_from_json(params_class: Type[P], obj: dict[str, Any] | None) -> P:
    """Bind a JSON object to a Params dataclass by field name.

    camelCase keys bind through a snake_case conversion; unknown keys
    are rejected (catching typos in engine.json); missing keys fall back
    to dataclass defaults.
    """
    obj = obj or {}
    if not dataclasses.is_dataclass(params_class):
        raise TypeError(f"{params_class} must be a dataclass")
    field_names = {f.name for f in dataclasses.fields(params_class)}
    renamed = {}
    for k, v in obj.items():
        key = k if k in field_names else _snake(k)
        if key in renamed:
            raise ValueError(
                f"Duplicate parameter {key!r} for {params_class.__name__} "
                f"(camelCase and snake_case forms both present)"
            )
        renamed[key] = v
    obj = renamed
    unknown = set(obj) - field_names
    if unknown:
        raise ValueError(
            f"Unknown parameter(s) {sorted(unknown)} for {params_class.__name__} "
            f"(accepted: {sorted(field_names)})"
        )
    kwargs = {}
    for f in dataclasses.fields(params_class):
        if f.name in obj:
            v = obj[f.name]
            # JSON arrays bind to tuple-typed fields as tuples
            if isinstance(v, list):
                ann = str(f.type)
                if ann.startswith(("tuple", "Tuple", "typing.Tuple")) or "Sequence" in ann:
                    v = tuple(v)
            kwargs[f.name] = v
    return params_class(**kwargs)


def params_to_json(params: Any) -> dict[str, Any]:
    """A Params dataclass (or a dict, or None) as a JSON object by field
    name: what evaluation reports and ``best.json`` write."""
    if params is None:
        return {}
    if dataclasses.is_dataclass(params):
        return dataclasses.asdict(params)
    if isinstance(params, dict):
        return dict(params)
    raise TypeError(f"cannot serialize params of type {type(params)}")


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """The full parameter set of one engine variant: (name, params) per
    component slot, algorithm list ordered."""

    data_source_params: tuple[str, Any] = ("", EmptyParams())
    preparator_params: tuple[str, Any] = ("", EmptyParams())
    algorithm_params_list: Sequence[tuple[str, Any]] = ()
    serving_params: tuple[str, Any] = ("", EmptyParams())

    def __post_init__(self):
        object.__setattr__(
            self, "algorithm_params_list", tuple(self.algorithm_params_list)
        )

    @staticmethod
    def of(
        data_source: Any = None,
        preparator: Any = None,
        algorithms: Sequence[tuple[str, Any]] = (),
        serving: Any = None,
    ) -> "EngineParams":
        """Convenience constructor for single-name engines."""
        return EngineParams(
            data_source_params=("", data_source if data_source is not None else EmptyParams()),
            preparator_params=("", preparator if preparator is not None else EmptyParams()),
            algorithm_params_list=tuple(algorithms),
            serving_params=("", serving if serving is not None else EmptyParams()),
        )
