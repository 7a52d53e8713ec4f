"""``pio experiment`` — drive the online A/B loop from the shell (a copy
of the JAX package's ``experiment/cli.py``).

Subcommands:

- ``pio experiment start <name> --instance <evalId> --top-k 2
  --backends host:port[,host:port] --backends ...`` — read the scored
  grid from the evaluation instance, pick the top-k surviving points,
  register each as a named engine behind a running ``pio router``
  (``POST /fleet/engines``, one ``--backends`` group per variant in
  rank order), and define the experiment over them
  (``POST /fleet/experiments``). From here the router owns the
  lifecycle: ramp → measure → promote|abort.
- ``pio experiment status`` — the live lifecycle + per-variant online
  evidence from ``GET /fleet/experiments``.
- ``pio experiment conversions <name> --appid N`` — sweep the event
  store for accepted events carrying this experiment's served
  attribution stamp (``experimentId``/``variantId`` properties,
  excluding the server's own ``predict`` feedback events) and POST
  the per-variant TOTALS to the router, closing the loop from serving
  back through the event store into the online score. Totals are
  cumulative, so re-running the sweep never double-counts.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request

logger = logging.getLogger(__name__)

_DEFAULT_ROUTER = "127.0.0.1:8100"


def _router_call(router: str, path: str, doc: dict | None,
                 router_key: str | None, timeout: float) -> dict:
    """One bounded JSON exchange with the router; raises SystemExit-free
    RuntimeError with the router's message on a non-2xx."""
    url = f"http://{router}{path}"
    if router_key:
        url += f"?accessKey={router_key}"
    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(
        url, data=data, method="POST" if doc is not None else "GET",
        headers={"Content-Type": "application/json"} if doc else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as exc:
        try:
            message = json.loads(exc.read()).get("message", str(exc))
        except Exception:  # noqa: BLE001
            message = str(exc)
        raise RuntimeError(f"router {path}: {message}") from exc
    except (urllib.error.URLError, OSError) as exc:
        raise RuntimeError(f"router {router} unreachable: {exc}") from exc


def _ranked_points(instance, top_k: int, ascending: bool) -> list[dict]:
    """The surviving grid points of an evaluation instance, best
    first. Rank order follows the score sign (``--ascending`` for
    lower-is-better metrics); FAILED / unscored points never deploy."""
    doc = json.loads(instance.evaluator_results_json or "{}")
    scored = [
        {"idx": i, "score": entry.get("score"),
         "engineParams": entry.get("engineParams")}
        for i, entry in enumerate(doc.get("engineParamsScores", []))
        if isinstance(entry.get("score"), (int, float))
    ]
    scored.sort(key=lambda e: e["score"], reverse=not ascending)
    return scored[:max(1, top_k)]


def _latest_completed(instances):
    for instance in instances.get_completed():
        return instance
    return None


def _cmd_start(args, storage) -> int:
    instances = storage.get_meta_data_evaluation_instances()
    if args.instance:
        instance = instances.get(args.instance)
    else:
        instance = _latest_completed(instances)
    if instance is None:
        print("[ERROR] no completed evaluation instance found "
              "(run `pio eval` first, or pass --instance)")
        return 1
    if instance.status != "EVALCOMPLETED":
        print(f"[ERROR] evaluation instance {instance.id} is "
              f"{instance.status}, not EVALCOMPLETED")
        return 1
    points = _ranked_points(instance, args.top_k, args.ascending)
    if not points:
        print(f"[ERROR] evaluation instance {instance.id} has no "
              "scored grid points")
        return 1
    backend_groups = [b.split(",") for b in (args.backends or [])]
    if len(backend_groups) != len(points):
        print(f"[ERROR] {len(points)} variant(s) need {len(points)} "
              f"--backends group(s), got {len(backend_groups)} "
              "(one comma-separated replica list per ranked variant)")
        return 1
    weight = 100.0 / len(points)
    variants = []
    for rank, (point, backends) in enumerate(zip(points, backend_groups)):
        engine_name = f"{args.name}-v{point['idx']}"
        try:
            _router_call(args.router, "/fleet/engines", {
                "action": "register",
                "engine": {"name": engine_name, "backends": backends},
            }, args.router_key, args.timeout)
        except RuntimeError as exc:
            if "already registered" not in str(exc):
                print(f"[ERROR] registering {engine_name}: {exc}")
                return 1
            print(f"[INFO] engine {engine_name} already registered")
        variants.append({"name": engine_name, "weightPct": weight,
                         "gridIdx": point["idx"],
                         "offlineScore": point["score"]})
        print(f"[INFO] variant #{rank} {engine_name}: grid point "
              f"{point['idx']} (offline score {point['score']}) on "
              f"{len(backends)} replica(s)")
    experiment = {"name": args.name, "rampS": args.ramp_s,
                  "measureS": args.measure_s,
                  "minRequests": args.min_requests,
                  "conversionWeight": args.conversion_weight,
                  "guardrail": {"minRequests": args.guardrail_min_requests,
                                "maxErrorRate": args.max_error_rate,
                                "maxP99Ms": args.max_p99_ms,
                                "window": args.guardrail_window}}
    try:
        doc = _router_call(args.router, "/fleet/experiments",
                           {"action": "define", "experiment": experiment,
                            "variants": variants},
                           args.router_key, args.timeout)
    except RuntimeError as exc:
        print(f"[ERROR] defining experiment: {exc}")
        return 1
    snap = doc.get("experiment") or {}
    print(f"[INFO] experiment {args.name} defined: state "
          f"{snap.get('state')} over "
          f"{len(snap.get('variants', []))} variant(s)")
    return 0


def _print_snapshot(snap: dict | None) -> None:
    if not snap:
        print("[INFO] no experiment defined")
        return
    decision = snap.get("decision") or {}
    verdict = (f" — winner {decision.get('winner')}"
               if decision.get("winner") else "")
    print(f"[INFO] experiment {snap.get('name')}: "
          f"{snap.get('state')}{verdict}")
    for v in snap.get("variants", []):
        flag = "ABORTED" if v.get("aborted") else \
            f"score {v.get('onlineScore')}"
        print(f"[INFO]   {v.get('name')} ({v.get('weightPct'):g}%): "
              f"{v.get('requests')} req, {v.get('errors')} err, "
              f"{v.get('conversions')} conv | {flag}")


def _cmd_status(args, storage) -> int:
    try:
        doc = _router_call(args.router, "/fleet/experiments", None,
                           args.router_key, args.timeout)
    except RuntimeError as exc:
        print(f"[ERROR] {exc}")
        return 1
    _print_snapshot(doc.get("experiment"))
    return 0


def sweep_conversions(storage, app_id: int, experiment: str,
                      channel_id: int | None = None) -> dict[str, int]:
    """Count accepted events carrying this experiment's attribution
    stamp, per variant — the event-store half of the conversion loop.
    The server-generated ``predict`` feedback events are excluded:
    serving a rec is not the user acting on it."""
    from predictionio_tpu_torch.storage.base import EventFilter

    counts: dict[str, int] = {}
    for event in storage.get_events().find(app_id, channel_id,
                                           EventFilter()):
        if event.event == "predict":
            continue
        try:
            if event.properties.get("experimentId") != experiment:
                continue
            variant = event.properties.get("variantId")
        except Exception:  # noqa: BLE001 — properties are client data
            continue
        if variant:
            counts[str(variant)] = counts.get(str(variant), 0) + 1
    return counts


def _cmd_conversions(args, storage) -> int:
    counts = sweep_conversions(storage, args.appid, args.name)
    if not counts:
        print(f"[INFO] no attributed conversion events for experiment "
              f"{args.name} in app {args.appid}")
        return 0
    try:
        doc = _router_call(args.router, "/fleet/experiments",
                           {"action": "conversions",
                            "experiment": args.name,
                            "conversions": counts},
                           args.router_key, args.timeout)
    except RuntimeError as exc:
        print(f"[ERROR] {exc}")
        return 1
    total = sum(counts.values())
    print(f"[INFO] folded {total} conversion(s) across "
          f"{len(counts)} variant(s) into experiment {args.name}")
    _print_snapshot(doc.get("experiment"))
    return 0


def _add_router_args(p) -> None:
    p.add_argument("--router", default=_DEFAULT_ROUTER,
                   metavar="HOST:PORT")
    p.add_argument("--router-key", default=None, dest="router_key")
    p.add_argument("--timeout", type=float, default=10.0)


def _configure_experiment(sub) -> None:
    p = sub.add_parser(
        "experiment",
        help="online A/B over grid-eval winners: deploy top-k variants "
             "behind the router, split traffic, auto-promote")
    ops = p.add_subparsers(dest="experiment_cmd", required=True)

    start = ops.add_parser("start", help="deploy top-k grid points as "
                                         "variants and start the experiment")
    start.add_argument("name", help="experiment id (rides every "
                                    "attribution stamp)")
    start.add_argument("--instance", default=None,
                       help="evaluation instance id (default: the "
                            "latest EVALCOMPLETED one)")
    start.add_argument("--top-k", type=int, default=2, dest="top_k")
    start.add_argument("--backends", action="append", metavar="HOST:PORT[,..]",
                       help="replica list for the k-th ranked variant "
                            "(repeat once per variant, rank order)")
    start.add_argument("--ascending", action="store_true",
                       help="lower score is better (error-style metrics)")
    start.add_argument("--ramp-s", type=float, default=5.0, dest="ramp_s")
    start.add_argument("--measure-s", type=float, default=30.0,
                       dest="measure_s")
    start.add_argument("--min-requests", type=int, default=20,
                       dest="min_requests")
    start.add_argument("--conversion-weight", type=float, default=0.5,
                       dest="conversion_weight")
    start.add_argument("--max-error-rate", type=float, default=0.5,
                       dest="max_error_rate")
    start.add_argument("--max-p99-ms", type=float, default=0.0,
                       dest="max_p99_ms")
    start.add_argument("--guardrail-min-requests", type=int, default=20,
                       dest="guardrail_min_requests")
    start.add_argument("--guardrail-window", type=int, default=200,
                       dest="guardrail_window")
    _add_router_args(start)

    status = ops.add_parser("status", help="lifecycle + per-variant "
                                           "online evidence")
    _add_router_args(status)

    conv = ops.add_parser(
        "conversions",
        help="sweep attributed conversion events from the event store "
             "into the router's online score")
    conv.add_argument("name", help="experiment id to sweep")
    conv.add_argument("--appid", type=int, required=True)
    _add_router_args(conv)


def _cmd_experiment(args, storage) -> int:
    if args.experiment_cmd == "start":
        return _cmd_start(args, storage)
    if args.experiment_cmd == "status":
        return _cmd_status(args, storage)
    if args.experiment_cmd == "conversions":
        return _cmd_conversions(args, storage)
    print(f"[ERROR] unknown experiment subcommand {args.experiment_cmd!r}")
    return 1


def register() -> None:
    from predictionio_tpu_torch.cli.pio import register_command

    register_command("experiment", _configure_experiment, _cmd_experiment)


register()
