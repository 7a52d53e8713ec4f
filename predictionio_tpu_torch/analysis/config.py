"""Per-rule, per-package lint configuration
(a copy of the JAX package's ``analysis/config.py``).

``default_config()`` encodes the repo policy: which package subtrees
each rule patrols and the rule-specific tables (the resilience guard
lists, the hot-path module set, the dtype whitelist). Tests and downstream
embedders build their own ``LintConfig`` to lint fixture trees or to
tighten/loosen scope without editing the rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from predictionio_tpu_torch.analysis.core import Rule, all_rules


@dataclasses.dataclass
class RuleConfig:
    """How one rule applies in a run."""

    enabled: bool = True
    #: package-relative path prefixes (e.g. ``"api/"``) or exact files
    #: (``"workflow/deploy.py"``); None -> the rule's ``default_paths``
    paths: tuple[str, ...] | None = None
    options: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LintConfig:
    """A full lint run: rule set + file exclusions."""

    rules: dict[str, RuleConfig] = dataclasses.field(default_factory=dict)
    #: package-relative prefixes skipped entirely
    exclude: tuple[str, ...] = ()

    def rule_paths(self, rule: Rule) -> tuple[str, ...]:
        rc = self.rules.get(rule.rule_id)
        if rc is not None and rc.paths is not None:
            return rc.paths
        return rule.default_paths

    def rule_options(self, rule: Rule) -> dict[str, Any]:
        rc = self.rules.get(rule.rule_id)
        return rc.options if rc is not None else {}

    def unscoped(self) -> "LintConfig":
        """A copy with every rule's path scope widened to the whole
        tree AND module-keyed policy options dropped — for linting
        ad-hoc files (fixtures, snippets) outside the package. The
        package guard tables are keyed by basename, so an unrelated
        file that happens to be called ``postgres.py`` must get the
        generic strict policy, not the repo's per-module expectations
        (which would report spurious stale-guard findings)."""
        return LintConfig(
            rules={
                rid: RuleConfig(
                    enabled=self.rules.get(rid, RuleConfig()).enabled,
                    paths=("",))
                for rid in {*all_rules(), *self.rules}
            },
            exclude=self.exclude,
        )

    def enabled_rules(self) -> dict[str, Rule]:
        return {
            rid: rule
            for rid, rule in all_rules().items()
            if self.rules.get(rid, RuleConfig()).enabled
        }


def path_matches(relpath: str, prefixes: tuple[str, ...]) -> bool:
    """True when ``relpath`` (forward slashes) falls under any prefix.
    ``""`` matches everything; ``"api/"`` matches the subtree;
    ``"workflow/deploy.py"`` matches exactly that file."""
    for p in prefixes:
        if p == "" or relpath == p:
            return True
        q = p if p.endswith("/") else p + "/"
        if relpath.startswith(q):
            return True
    return False


#: the compute subtrees that must stay device-friendly (f32/bf16, pure
#: compiled programs)
COMPUTE_PATHS = ("ops/", "models/", "e2/")

#: request-serving hot path: handler threads, the deployed query path,
#: the batching/cache subsystem (serving/), the columnar data plane's
#: scan/view consumers (data/: a host sync inside the train-read loop
#: would serialize every batch), the observability plane (obs/), which
#: runs INSIDE every request and must never block on the device, the
#: fleet router (fleet/), which sits on EVERY fleet query, and the ANN
#: retrieval path (ops/ann.py), whose probe/rescore answers every
#: sublinear query (build/quality helpers are host-side by design and
#: carry justified suppressions)
#: online/ rides along: the overlay reads sit INSIDE every
#: recommendation query once --online is live, and the fold loop's
#: deliberate host syncs (per-generation constants, per-user gathers on
#: the background tail thread) carry justified suppressions
#: fleet/gateway.py is covered by the fleet/ prefix here and in every
#: fleet-scoped rule below (resilience-bypass, untimed-blocking-io incl.
#: banned_sleep_paths): the engine-table resolution runs on EVERY
#: gateway query, the gateway itself does no I/O (routing + token
#: buckets only), and its table-mutation paths must never grow a bare
#: sleep or an untimed fetch; the per-tenant elasticity plane
#: (CapacityArbiter, EngineScaleSet, burst credits) rides the same
#: prefix
#: the shared-memory serving plane (serving/shm_cache.py,
#: serving/placement.py) is covered by the serving/ prefix here and in
#: every serving-scoped rule below: the seqlock cache sits INSIDE every
#: cached query, must never grow network I/O or a host sync, and its
#: bounded read-retry loop must stay sleep-free (serving/shm_cache.py is
#: in banned_sleep_paths to keep it that way)
#: the experimentation plane (experiment/) rides here because the
#: variant-assignment + attribution-stamp path sits on EVERY bare
#: /queries.json through the router, the controller's tick runs inside
#: record() on the request path, and the grid scheduler's join loop
#: must stay on bounded waits
HOT_PATHS = ("api/", "workflow/deploy.py", "serving/", "data/", "obs/",
             "fleet/", "ops/ann.py", "online/", "experiment/")


def default_config() -> LintConfig:
    """The repo policy `pio lint` and the tier-1 gate run with: the JAX
    package's policy, rule for rule and path for path, with the
    resilience layer named as this package's."""
    return LintConfig(
        rules={
            "resilience-bypass": RuleConfig(
                # serving/, data/, obs/ and the event server's ingest
                # path carry the strictest policy (no guard-table
                # entries): any raw network call there is a violation —
                # the columnar scan and batch-ingest paths must reach
                # remote backends only through the DAO layer's
                # resilient() wrappers, and the observability plane
                # must never do network I/O of its own (scrapers pull;
                # the plane never pushes)
                # fleet/ and the router's HTTP surface ride along: the
                # router's ONE raw-socket site is the transport's
                # connect, declared below; everything else in the fleet
                # tier must reach replicas only through
                # resilient()-routed exchanges
                # online/: the freshness plane reaches storage only
                # through the DAO layer's resilient() wrappers and does
                # no network I/O of its own — the spool plane is files,
                # the overlay is memory
                paths=("storage/", "serving/", "data/", "obs/", "fleet/",
                       "online/",
                       "api/event_server.py", "api/router_server.py"),
                options={
                    # raw-network callables we police
                    "net_calls": ["urlopen", "create_connection"],
                    # module basename -> qualnames allowed to hold raw
                    # network calls; everything else must be network-free
                    "guarded_sites": {
                        "elasticsearch.py": ["ESClient._raw_request"],
                        "s3.py": ["S3Models._raw_request"],
                        "pgwire.py": ["_open_socket"],
                        "postgres.py": [],
                        "hdfs.py": [],
                        "transport.py": ["BackendTransport._connect"],
                    },
                    # module basename -> functions referable (outside
                    # their own def) only inside a resilient(...) call
                    "resilient_only": {
                        "elasticsearch.py": ["_raw_request"],
                        "s3.py": ["_raw_request"],
                        "postgres.py": ["_open_connection"],
                        "hdfs.py": ["_write", "_read", "_remove"],
                    },
                    # module basename -> {func: [allowed enclosing
                    # qualnames]}: the raw function may be referenced
                    # only from those functions (the pgwire socket
                    # opener is reachable solely from PGConnection
                    # construction, which the ctor guard below pins to
                    # the pool's resilient-wrapped connect)
                    "call_guard": {
                        "pgwire.py": {
                            "_open_socket": ["PGConnection.__init__"],
                        },
                        # the fleet transport's socket opener is
                        # reachable only from the request exchange,
                        # whose callers route through
                        # resilient(backend.resilience, ...) at the
                        # router layer (fleet/router._exchange)
                        "transport.py": {
                            "_connect": ["BackendTransport.request"],
                        },
                    },
                    # module basename -> {ClassName: enclosing function}:
                    # the class may only be constructed inside that
                    # function (pgwire's socket guard routes through the
                    # pool's resilient-wrapped connect)
                    "ctor_guard": {
                        "postgres.py": {"PGConnection": "_open_connection"},
                    },
                    # modules with guarded sites must import the layer:
                    # this package's own, which is the one policy line
                    # that differs from the JAX package's
                    "require_import": "predictionio_tpu_torch.utils.resilience",
                    # pgwire is guarded one level up, in postgres.py
                    "no_import_ok": ["pgwire.py"],
                },
            ),
            # the device/compiler observability layer rides along:
            # obs/compile.py is the build sentinel and obs/device.py
            # prices the programs — any compiled helper growing there
            # must obey the same purity contract as the compute modules
            # it instruments
            # The rule recognises jax.jit/pjit/instrumented_jit entry
            # points only. This package compiles nothing that way (it
            # uses no torch.compile, torch.jit or CUDA graph), so on its
            # tree the rule finds no entry point and stays silent; the
            # scope is kept so the policy equals the JAX package's.
            "jit-purity": RuleConfig(
                paths=COMPUTE_PATHS + ("obs/compile.py", "obs/device.py")),
            "host-sync-in-hot-path": RuleConfig(paths=HOT_PATHS),
            "dtype-discipline": RuleConfig(paths=COMPUTE_PATHS),
            # storage/ included: a blocked pgwire connect is not
            # interruptible by the retry layer, so it keeps its timeout.
            # fleet/ + obs/ + cli/ cover the fleet-observability
            # fan-out paths (worker-peer fetches, /fleet/metrics
            # replica scrapes, /traces.json stitching, `pio trace`):
            # every cross-process fetch must carry a timeout, so the
            # transport's kw-only `timeout` is policed too (`request`
            # with a large positional index: it can only be passed by
            # keyword, and its absence is the finding)
            # serving/: the engine side of the prefork pool's
            # worker-coherence machinery (serving/workers.py) must never
            # grow an untimed fetch or a bare sleep in its sync loop
            # data/wal.py: the WAL drainer's retry loop must ride
            # clock.sleep/Event.wait — a bare time.sleep there is
            # unstoppable during shutdown and untestable on a
            # ManualClock
            # online/: the fold loop must ride Event.wait, and any
            # cross-process fetch growing there must carry a timeout
            "untimed-blocking-io": RuleConfig(
                paths=("api/", "storage/", "fleet/", "obs/", "cli/",
                       "serving/", "data/wal.py", "online/",
                       "experiment/"),
                options={
                    "policed_calls": {
                        "urlopen": 2, "create_connection": 1,
                        "request": 99,
                    },
                    # "request" means the fleet transport's exchange
                    # only on the fan-out paths; the ES client's own
                    # request() binds its timeout internally
                    "call_paths": {
                        "request": ["fleet/", "obs/",
                                    "api/router_server.py"],
                    },
                    # supervision loops (fleet/supervisor.py,
                    # fleet/controller.py and everything else in the
                    # fleet tier): child-process wait()/poll() loops
                    # must be clock-injectable, so a bare time.sleep
                    # there is a finding — use clock.sleep or
                    # Event.wait
                    # serving/shm_cache.py: the seqlock reader's bounded
                    # retry must SPIN-then-miss, never sleep — a
                    # sleeping reader inside /queries.json is exactly
                    # the reader-blocks-on-writer coupling the seqlock
                    # exists to remove
                    # experiment/: the controller ticks inside the
                    # request path and the grid's join loop must stay
                    # on ProcessHandle.wait(timeout)
                    "banned_sleep_paths": ["fleet/",
                                           "serving/workers.py",
                                           "serving/shm_cache.py",
                                           "data/wal.py",
                                           "online/",
                                           "experiment/"],
                },
            ),
            "lock-discipline": RuleConfig(paths=("",)),
            # -- project-phase rules: whole-tree scope; the
            # ProjectModel is built from every module in the run, so
            # narrowing `paths` only narrows where findings ANCHOR,
            # not what the analysis sees
            "shared-state-race": RuleConfig(paths=("",)),
            "lock-order": RuleConfig(paths=("",)),
            # Like jit-purity, this rule keys on jax.jit-style entry
            # points, which this package does not have: on its tree the
            # only live part is extra_entries.
            "jit-recompile-risk": RuleConfig(
                paths=("",),
                options={
                    # width-menu snappers (ops/topk.py): a static arg
                    # routed through one of these is pinned to the
                    # BATCH_WIDTHS/_K_WIDTHS menus and cannot drift
                    "snap_calls": ["serving_k", "serving_batch"],
                    # factory-backed compiled wrappers: plain functions
                    # whose named params key a cached compiled program
                    # (the sharded top-k of ops/topk.py, whose k sizes
                    # each position's local top-k and the merge).
                    "extra_entries": {"recommend_topk_sharded": ["k"]},
                },
            ),
        },
        exclude=("__pycache__/",),
    )
