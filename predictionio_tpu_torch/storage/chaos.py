"""Fault-injection ("chaos") storage backend (a copy of the JAX
package's ``storage/chaos.py``).

Wraps any registered Events/metadata/Models backend and injects seeded,
DETERMINISTIC faults and latency at the DAO boundary, so the whole stack
— ingest, training reads, model persistence, serving — can be
chaos-tested end to end with reproducible runs (beyond reference: the
reference proved fault behavior only against live dockerized stores).

Two invariants make injected faults safe to retry:

- a fault fires BEFORE the inner operation runs, so a faulted call
  never partially applies — retrying cannot duplicate or lose data;
- the fault sequence is drawn from one seeded ``random.Random``, so a
  given (seed, operation sequence) always fails at the same points.

The chaos client carries its own :class:`Resilience` ABOVE the injector,
exactly like a remote backend wraps its network boundary: callers see
either the inner backend's normal result (after invisible retries) or a
:class:`StorageUnavailableError` — never a raw injected fault.

Registered in the storage registry as type ``chaos``. Config
(``PIO_STORAGE_SOURCES_<NAME>_*``):

- ``TARGET`` (required) — the wrapped backend's registered type; every
  ``TARGET_<KEY>`` property is forwarded to it as ``<KEY>``. (Named
  ``TARGET`` rather than ``TARGET_TYPE`` because the registry's env
  parser would read a ``…_TYPE`` suffix as its own source declaration;
  ``TARGET_TYPE`` is still accepted in programmatic configs.)
- ``FAULT_RATE`` (default ``0.3``) — probability a call faults.
- ``SEED`` (default ``0``) — the deterministic fault stream.
- ``ERROR`` (default ``chaos``) — injected class: ``chaos``
  (:class:`ChaosError`), ``connection`` (ConnectionError) or
  ``timeout`` (TimeoutError).
- ``LATENCY_MS`` (default ``0``; ``DELAY_MS`` is an alias) — mean
  injected latency; ``LATENCY_JITTER_MS`` adds a uniform spread.
- ``DELAY_PROB`` (default ``1.0``) — probability a call is delayed at
  all, drawn from the same seeded stream as the faults: slow-backend
  behavior (some calls slow, most fast — the long-tail shape that
  defeats a fixed timeout) becomes testable deterministically.
- the standard ``RETRY_*``/``BREAKER_*`` knobs (defaults here are
  retry-heavy: 12 attempts at 1ms base, breaker off) so a 30% fault
  rate is absorbed invisibly unless the operator tightens the policy.

Python API: ``ChaosStorageClient.wrap(inner_client, fault_rate=…,
seed=…)`` wraps an already-built client (how the chaos conformance
tests run sqlite/memory under fault injection).
"""

from __future__ import annotations

import functools
import random
import threading
from typing import Callable

from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import BaseStorageClient, StorageClientConfig
from predictionio_tpu_torch.utils.resilience import (
    SYSTEM_CLOCK,
    Clock,
    Resilience,
    RetryPolicy,
    TransientError,
    resilient,
)


class ChaosError(TransientError):
    """An injected transient fault."""


_ERROR_CLASSES: dict[str, Callable[[str], BaseException]] = {
    "chaos": lambda op: ChaosError(f"injected fault in {op}"),
    "connection": lambda op: ConnectionError(f"injected connection loss in {op}"),
    "timeout": lambda op: TimeoutError(f"injected timeout in {op}"),
}


class ChaosInjector:
    """Seeded fault/latency source shared by all DAOs of one source."""

    def __init__(
        self,
        fault_rate: float = 0.3,
        seed: int = 0,
        error: str = "chaos",
        latency_ms: float = 0.0,
        latency_jitter_ms: float = 0.0,
        delay_prob: float = 1.0,
        clock: Clock = SYSTEM_CLOCK,
    ):
        if error not in _ERROR_CLASSES:
            raise ValueError(
                f"unknown chaos ERROR {error!r} "
                f"(choose from {sorted(_ERROR_CLASSES)})")
        self.fault_rate = fault_rate
        self.seed = seed
        self._error = _ERROR_CLASSES[error]
        self._latency = latency_ms / 1e3
        self._jitter = latency_jitter_ms / 1e3
        #: probability a call is delayed at all (1.0 = every call, the
        #: pre-PR 6 behavior); < 1.0 models a long-tail slow backend
        self._delay_prob = delay_prob
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.faults_injected = 0
        self.delays_injected = 0
        self.calls = 0

    def set_fault_rate(self, fault_rate: float) -> None:
        """Thread-safe runtime fault-rate flip — the chaos suites'
        outage window (``set_fault_rate(1.0)`` = hard outage,
        ``set_fault_rate(0.0)`` = recovery) without racing the seeded
        draw in :meth:`before` on another thread."""
        with self._lock:
            self.fault_rate = fault_rate

    def before(self, op: str) -> None:
        """Maybe sleep, maybe raise — always BEFORE the inner op runs."""
        with self._lock:
            self.calls += 1
            roll = self._rng.random()
            latency = 0.0
            if self._latency or self._jitter:
                # the delay roll is drawn only when delay_prob < 1.0,
                # keeping the (seed, op-sequence) fault stream of
                # always-delay and no-latency configs unchanged
                delayed = (self._delay_prob >= 1.0
                           or self._rng.random() < self._delay_prob)
                if delayed:
                    latency = (self._latency
                               + self._rng.uniform(0, self._jitter))
                    self.delays_injected += 1
            fault = roll < self.fault_rate
            if fault:
                self.faults_injected += 1
        if latency > 0:
            self._clock.sleep(latency)
        if fault:
            raise self._error(op)


class _ChaosDAO:
    """Generic proxy: every public DAO method gets fault injection plus
    the resilient() wrapper; private attrs and ``close`` pass through
    (cleanup must never flake)."""

    _PASSTHROUGH = frozenset({"close"})

    def __init__(self, inner, injector: ChaosInjector, resilience: Resilience):
        self._inner = inner
        self._injector = injector
        self._resilience = resilience

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if (name.startswith("_") or not callable(attr)
                or name in self._PASSTHROUGH):
            return attr

        @functools.wraps(attr)
        def guarded(*args, **kwargs):
            def attempt():
                self._injector.before(name)
                return attr(*args, **kwargs)
            return resilient(self._resilience, attempt)

        self.__dict__[name] = guarded  # cache per proxy instance
        return guarded


class ChaosStorageClient(BaseStorageClient):
    """Registered as type ``chaos``; see the module docstring."""

    prefix = "CHAOS"

    def __init__(self, config: StorageClientConfig = StorageClientConfig()):
        super().__init__(config)
        props = config.properties
        target_type = props.get("TARGET") or props.get("TARGET_TYPE")
        if not target_type:
            raise ValueError(
                "chaos storage source requires a TARGET property "
                "naming the wrapped backend type")
        source = props.get("SOURCE_NAME", f"{target_type}")
        inner_props = {
            k[len("TARGET_"):]: v for k, v in props.items()
            if k.startswith("TARGET_") and k != "TARGET_TYPE"
        }
        inner_props.setdefault("SOURCE_NAME", f"{source}/target")
        from predictionio_tpu_torch.storage import registry  # avoid import cycle

        registry._builtin_backends()
        if target_type not in registry._BACKENDS:
            raise registry.StorageError(
                f"chaos TARGET_TYPE {target_type!r} is not a registered "
                f"backend type (available: {sorted(registry._BACKENDS)})")
        inner = registry._BACKENDS[target_type](
            StorageClientConfig(
                parallel=config.parallel, test=config.test,
                properties=inner_props))
        self._init_wrapping(
            inner,
            injector=ChaosInjector(
                fault_rate=float(props.get("FAULT_RATE", "0.3")),
                seed=int(props.get("SEED", "0")),
                error=props.get("ERROR", "chaos"),
                latency_ms=float(props.get(
                    "LATENCY_MS", props.get("DELAY_MS", "0"))),
                latency_jitter_ms=float(props.get("LATENCY_JITTER_MS", "0")),
                delay_prob=float(props.get("DELAY_PROB", "1.0")),
            ),
            resilience=Resilience.from_properties(
                f"chaos/{source}", props,
                max_attempts=12, base_delay=0.001, max_delay=0.02,
                failure_threshold=0),
        )

    def _init_wrapping(self, inner: BaseStorageClient,
                       injector: ChaosInjector,
                       resilience: Resilience) -> None:
        self.inner = inner
        self.injector = injector
        self.resilience = resilience
        self._daos: dict[str, _ChaosDAO] = {}
        self._lock = threading.Lock()

    @classmethod
    def wrap(
        cls,
        inner: BaseStorageClient,
        fault_rate: float = 0.3,
        seed: int = 0,
        error: str = "chaos",
        latency_ms: float = 0.0,
        latency_jitter_ms: float = 0.0,
        delay_prob: float = 1.0,
        resilience: Resilience | None = None,
        name: str = "chaos",
        clock: Clock = SYSTEM_CLOCK,
    ) -> "ChaosStorageClient":
        """Wrap an already-constructed client (test/notebook API)."""
        self = cls.__new__(cls)
        BaseStorageClient.__init__(self, inner.config)
        self._init_wrapping(
            inner,
            injector=ChaosInjector(
                fault_rate=fault_rate, seed=seed, error=error,
                latency_ms=latency_ms, latency_jitter_ms=latency_jitter_ms,
                delay_prob=delay_prob, clock=clock),
            resilience=resilience or Resilience(
                name,
                policy=RetryPolicy(max_attempts=12, base_delay=0.001,
                                   max_delay=0.02),
                clock=clock,
            ),
        )
        return self

    def _wrapped(self, kind: str, factory) -> _ChaosDAO:
        with self._lock:
            if kind not in self._daos:
                self._daos[kind] = _ChaosDAO(
                    factory(), self.injector, self.resilience)
            return self._daos[kind]

    def events(self) -> base.Events:
        return self._wrapped("events", self.inner.events)

    def apps(self) -> base.Apps:
        return self._wrapped("apps", self.inner.apps)

    def access_keys(self) -> base.AccessKeys:
        return self._wrapped("access_keys", self.inner.access_keys)

    def channels(self) -> base.Channels:
        return self._wrapped("channels", self.inner.channels)

    def engine_instances(self) -> base.EngineInstances:
        return self._wrapped("engine_instances", self.inner.engine_instances)

    def evaluation_instances(self) -> base.EvaluationInstances:
        return self._wrapped("evaluation_instances",
                             self.inner.evaluation_instances)

    def models(self) -> base.Models:
        return self._wrapped("models", self.inner.models)

    def close(self) -> None:
        self.inner.close()
