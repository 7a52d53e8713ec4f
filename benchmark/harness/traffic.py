"""The one generator of the benchmark's inputs. A traffic mix is a JSON
file under ``benchmark/traffic/``; this module reads its parameters and
draws everything from the run's seed, so the same seed gives the same
inputs and a new mix needs no new code.

Distributions (a ``{"dist": ...}`` object):

- ``{"dist": "uniform_int", "low": a, "high": b}``: integers a..b
- ``{"dist": "log_uniform_int", "low": a, "high": b}``: integers whose
  logarithm is uniform over [log a, log b + 1)
- ``{"dist": "power_int", "n": n, "exponent": e, "offset": o}``:
  ``o + floor(n · u^e)`` for u uniform on [0, 1): the repository's
  power-law skew (``e`` > 1 favours small values)

Every integer distribution may carry ``"scale": c``, which multiplies the
draws (as floats) after they are drawn, and ``"stratified": true``: the
uniform numbers behind ``size`` draws are then the midpoints of ``size``
equal strata of [0, 1) in a seeded order, so every seed draws the same
multiset of values, in another order (the same work for every seed).

A stream of batches of keys (:func:`batches`) may also take
``{"dist": "shuffled_cycle", "low": a, "high": b}``: the keys a..b in a
seeded order, then again in a new order, and so on: uniform over the
keys, and every key equally often over a long window.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

#: numpy's generators take any non-negative integer as a seed; the
#: benchmark's seeds can pass 2**31, so streams are told apart by a
#: second word rather than by adding to the seed
_STREAMS = {"weights": 1, "data": 2, "queries": 3, "warmup": 4, "sample": 5, "check": 6}


def rng(seed: int, stream: str) -> np.random.Generator:
    """The seeded generator of one named stream of a run."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), _STREAMS[stream]])


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a ``torch.Generator`` of one stream."""
    return int(rng(seed, stream).integers(0, 1 << 62))


def _uniform(spec: Mapping, size: int, gen: np.random.Generator) -> np.ndarray:
    if spec.get("stratified"):
        return (gen.permutation(size) + 0.5) / size
    return gen.random(size)


def draw(spec: Mapping, size: int, gen: np.random.Generator) -> np.ndarray:
    """``size`` draws of the distribution ``spec``."""
    kind = spec["dist"]
    if kind == "uniform_int":
        span = spec["high"] + 1 - spec["low"]
        out = spec["low"] + np.minimum((_uniform(spec, size, gen) * span).astype(np.int64),
                                       span - 1)
    elif kind == "log_uniform_int":
        lo, hi = np.log(spec["low"]), np.log(spec["high"] + 1)
        u = _uniform(spec, size, gen)
        out = np.minimum(np.exp(lo + (hi - lo) * u).astype(np.int64), spec["high"])
    elif kind == "power_int":
        u = _uniform(spec, size, gen)
        out = spec.get("offset", 0) + (spec["n"] * u ** spec["exponent"]).astype(np.int64)
        out = np.minimum(out, spec.get("offset", 0) + spec["n"] - 1)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    if "scale" in spec:
        out = out.astype(np.float64) * spec["scale"]
    return out


def resolve(spec: Mapping, env: Mapping) -> dict:
    """``spec`` with every string value of the form ``"$name"`` replaced
    by ``env[name]``: a traffic file can say ``"n": "$vocab"`` and take the
    size from the configuration it runs with."""
    out = {}
    for key, value in spec.items():
        if isinstance(value, str) and value.startswith("$"):
            value = env[value[1:]]
        elif isinstance(value, Mapping):
            value = resolve(value, env)
        out[key] = value
    return out


def sequences(spec: Mapping, count: int, env: Mapping,
              gen: np.random.Generator) -> list[np.ndarray]:
    """``count`` item sequences: lengths from ``spec["length"]``, items
    from ``spec["items"]``, drawn in one bulk call each."""
    lengths = draw(resolve(spec["length"], env), count, gen).astype(np.int64)
    flat = draw(resolve(spec["items"], env), int(lengths.sum()), gen).astype(np.int64)
    return np.split(flat, np.cumsum(lengths)[:-1])


def triples(spec: Mapping, env: Mapping, gen: np.random.Generator
            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``env["ratings"]`` (row, column, value) triples: rows from
    ``spec["rows"]``, columns from ``spec["cols"]``, values from
    ``spec["values"]``."""
    n = int(env["ratings"])
    rows = draw(resolve(spec["rows"], env), n, gen).astype(np.int32)
    cols = draw(resolve(spec["cols"], env), n, gen).astype(np.int32)
    vals = draw(resolve(spec["values"], env), n, gen).astype(np.float32)
    return rows, cols, vals


def batches(spec: Mapping, env: Mapping, gen: np.random.Generator):
    """An endless stream of batches of keys: ``spec["batch"]`` draws of
    ``spec["keys"]`` each."""
    keys = resolve(spec["keys"], env)
    size = int(spec["batch"])
    if keys["dist"] != "shuffled_cycle":
        while True:
            yield draw(keys, size, gen).astype(np.int64)
    pool = np.arange(keys["low"], keys["high"] + 1, dtype=np.int64)
    buf = pool[:0]
    while True:
        while len(buf) < size:
            buf = np.concatenate([buf, gen.permutation(pool)])
        yield buf[:size]
        buf = buf[size:]
