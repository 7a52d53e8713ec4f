"""`pio`: the command line over one store (port of the JAX package's
``cli/pio.py`` and ``workflow/cli_commands.py``, for the commands this
port serves).

    python -m predictionio_tpu_torch.cli.pio <command> ...

- ``version``; ``status`` (verifies every storage repository; with
  ``--router HOST:PORT``, a running router's engine table instead);
- ``app new|list|show|delete|data-delete|channel-new|channel-delete``
  (a new app gets an access key) and ``accesskey new|list|delete``
  (``new --event E`` whitelists event names);
- ``import`` / ``export``: events as JSON lines or, with ``--format
  parquet`` (import: also a ``*.parquet`` input), Parquet (pyarrow);
- ``eventserver``: the event server (``api/event_server.py``) in this
  process, with ``--stats``, ``--tracing/--no-tracing`` (absent:
  ``PIO_TRACE``) and the write-ahead journal flags
  ``--wal-dir``, ``--wal-fsync``, ``--wal-max-bytes``, ``--wal-policy``
  (an absent flag leaves the ``PIO_EVENTSERVER_WAL_*`` default);
  ``wal status|replay|dead-letter``: operate that journal;
- ``train``: ``workflow/train.run_train`` of an engine.json variant,
  recording an engine instance; ``--profile`` writes the train report
  (``obs/device.TrainProfiler``: stage split, builds, FLOPs, MFU, device
  memory) to ``--profile-out`` (default ./TRAIN_REPORT.json), and
  ``--profile-dir`` also a ``torch.profiler`` Chrome trace;
- ``eval <evaluation> [<generator>] [--batch] [--parallel N]``:
  ``workflow/evaluation.run_evaluation`` of an Evaluation over an
  EngineParamsGenerator (given as "pkg.module.Obj" specs; without a
  generator, the first one in the evaluation's module), recording an
  evaluation instance; ``--parallel N`` (else ``PIO_EVAL_PARALLEL``)
  forks N eval workers over the grid (``experiment/grid.py``);
- ``deploy``: the engine server over a stored instance (by
  ``--engine-instance-id``, else the latest COMPLETED one), one process,
  with the serving flags ``--server-key``, ``--batching/--no-batching``,
  ``--batch-policy``, ``--batch-max``, ``--batch-wait-ms``,
  ``--cache/--no-cache``, ``--cache-max-entries``, ``--cache-ttl-s`` and
  ``--request-deadline-ms``, the retrieval flags ``--retrieval
  {brute,ann}``, ``--ann-nlist``, ``--ann-nprobe``, ``--ann-rescore`` and
  the freshness plane's ``--online/--no-online``,
  ``--online-interval-s``, ``--online-overlay-max``,
  ``--online-state-dir`` (an absent flag leaves the ``PIO_SERVING_*`` or
  ``PIO_ONLINE_*`` default), ``--tracing/--no-tracing`` (absent:
  ``PIO_TRACE``), and the feedback loop ``--feedback
  --event-server-ip --event-server-port --accesskey``; the prefork pool
  ``--workers N`` (N engine-server processes on one ``SO_REUSEPORT``
  port; every sibling starts from the ``spawn`` context, after this
  process has built the kernels) with ``--supervise`` (respawn dead
  siblings), ``--shm-cache``/``--shm-slots``/``--shm-slot-bytes`` (one
  shared result cache) and ``--model-mmap`` (the npz checkpoints mapped:
  the workers share their host pages); ``undeploy``: POST /stop to a
  running one (in a pool, to whichever worker the connection reaches:
  stop a pool with SIGTERM to the deploy process);
- ``router``: the fleet router (``api/router_server.py``) in front of
  ``--backend`` replicas, with canaries (``--canary-backend``,
  ``--canary-weight``), ``--engine`` groups, ``--workers N`` siblings
  (from the ``spawn`` context) and, with ``--supervise``, the replicas
  that ``--replica-cmd`` starts and the scale controller; the router
  process imports no torch; ``trace <id>``: one routed request's
  stitched trace tree, as text or ``--chrome`` JSON;
- ``lint [paths] [--rule R] [--list-rules] [--format text|json|sarif]
  [--baseline F] [--write-baseline F] [--changed] [--no-project]
  [--no-cache]``: the AST invariant checker (``analysis/``) over this
  package, with the JAX package's nine rules, flags, output formats and
  exit codes; it imports no torch;
- ``experiment start|status|conversions`` (``experiment/cli.py``,
  registered through :func:`register_command`): the online A/B loop over
  an evaluation's ranked grid points behind a running router.
- ``dashboard`` (``tools/dashboard.py``: completed evaluations, CORS,
  ``/metrics``) and ``adminserver`` (``tools/admin.py``: app
  administration over REST); ``build`` (the engine.json's factory
  imports, instantiates and binds its params), ``run <module[:fn]>``
  (a user main in this process, over the configured storage), and the
  retired ``upgrade`` and ``template``, which exit 1 as in the JAX
  package. These six register through :func:`register_command`.

``train``, ``eval`` and ``deploy`` run on the card unless ``--device
cpu`` is given; ``status`` without ``--router`` imports torch to name
the card; ``build`` and ``run`` import it only through the engine or
main they load; the other commands, ``eventserver`` among them, do not
import torch. Storage is configured as the JAX package configures it (the
``PIO_STORAGE_*`` variables; with none set, sqlite + localfs under
``$PIO_FS_BASEDIR``), so both packages can work on one store. Arguments,
messages and exit codes are the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.storage.base import AccessKey, App, Channel
from predictionio_tpu_torch.storage.registry import Storage


def find_channel(storage: Storage, app_id: int, channel_name: str):
    """Channel-by-name within an app, or None."""
    channels = storage.get_meta_data_channels().get_by_app_id(app_id)
    return next((c for c in channels if c.name == channel_name), None)


def _cmd_version(args, storage: Storage | None) -> int:
    print(__version__)
    return 0


def _cmd_status(args, storage: Storage | None) -> int:
    """``pio status``; with ``--router HOST:PORT``, the registered engine
    table of a running fleet router instead (storage-free, no torch)."""
    if args.router:
        return _status_router(args)
    import torch

    print("[INFO] Inspecting predictionio_tpu_torch...")
    try:
        storage.verify_all_data_objects()
        print("[INFO] Storage: all repositories verified (metadata/eventdata/modeldata)")
    except Exception as exc:
        print(f"[ERROR] Storage check failed: {exc}")
        return 1
    if torch.cuda.is_available():
        print(f"[INFO] PyTorch {torch.__version__}: {torch.cuda.get_device_name(0)} "
              f"x{torch.cuda.device_count()}")
    else:
        print(f"[WARN] PyTorch {torch.__version__}: no CUDA device; "
              "train and deploy need --device cpu")
    print("[INFO] Your system is all ready to go.")
    return 0


def _status_router(args) -> int:
    """`pio status --router host:port`: the router's registered engines
    from ``GET /fleet/engines`` (name, group sizes, up counts, canary
    weight, quota, scale set) and its experiment, if one runs."""
    import urllib.error
    import urllib.request

    url = f"http://{args.router}/fleet/engines"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout or 10.0) as r:
            doc = json.loads(r.read())
    except (urllib.error.URLError, OSError, ValueError) as exc:
        print(f"[ERROR] router {args.router} unreachable: {exc}")
        return 1
    engines = doc.get("engines", [])
    default = doc.get("defaultEngine")
    print(f"[INFO] Fleet router {args.router}: {len(engines)} engine(s)"
          f" (default: {default})")
    for eng in engines:
        name = eng.get("name")
        marker = "*" if name == default else " "
        parts = []
        for group, counts in sorted((eng.get("groups") or {}).items()):
            parts.append(f"{group} {counts.get('up', 0)}/"
                         f"{counts.get('size', 0)} up")
        canary = eng.get("canary") or {}
        weight = canary.get("weightPct", 0.0)
        state = (f"canary {weight:g}%"
                 + (" ABORTED" if canary.get("aborted") else ""))
        quota = eng.get("quota") or {}
        if quota.get("limited"):
            state += (f" | quota qps={quota.get('qps') or 'inf'}"
                      f" inflight<={quota.get('maxInflight') or 'inf'}")
        scale = eng.get("scale")
        if scale:
            last = scale.get("lastDecision")
            reason = scale.get("lastReason")
            state += (f" | replicas {scale.get('actualReplicas')}"
                      f" (desired {scale.get('desiredReplicas')},"
                      f" bounds {scale.get('minReplicas')}-"
                      f"{scale.get('maxReplicas')}"
                      + (", dry-run" if scale.get("dryRun") else "")
                      + ")"
                      + (f" | last {last}:{reason}" if last else ""))
        print(f"[INFO]  {marker} {name}: "
              f"{'; '.join(parts) or 'no backends'} | {state}")
    experiment = doc.get("experiment")
    if experiment:
        decision = experiment.get("decision") or {}
        verdict = (f" — winner {decision.get('winner')}"
                   if decision.get("winner") else "")
        print(f"[INFO] Experiment {experiment.get('name')}: "
              f"{experiment.get('state')}{verdict}")
        for v in experiment.get("variants", []):
            flag = "ABORTED" if v.get("aborted") else \
                f"score {v.get('onlineScore')}"
            print(f"[INFO]    {v.get('name')} ({v.get('weightPct'):g}%): "
                  f"{v.get('requests')} req, {v.get('errors')} err, "
                  f"{v.get('conversions')} conv | {flag}")
    return 0


def _cmd_app(args, storage: Storage) -> int:
    apps = storage.get_meta_data_apps()
    keys = storage.get_meta_data_access_keys()
    channels = storage.get_meta_data_channels()
    events = storage.get_events()
    if args.app_command == "new":
        if args.access_key and keys.get(args.access_key) is not None:
            print(f"[ERROR] Access key {args.access_key} already exists.")
            return 1
        app_id = apps.insert(App(args.id or 0, args.name, args.description))
        if app_id is None:
            print(f"[ERROR] App {args.name} already exists.")
            return 1
        events.init(app_id)
        key = keys.insert(AccessKey(args.access_key or "", app_id, ()))
        if key is None:
            print(f"[ERROR] Access key {args.access_key} already exists.")
            return 1
        print("[INFO] Created a new app:")
        print(f"[INFO]         Name: {args.name}")
        print(f"[INFO]           ID: {app_id}")
        print(f"[INFO]   Access Key: {key}")
        return 0
    if args.app_command == "list":
        for app in apps.get_all():
            app_keys = keys.get_by_app_id(app.id)
            key_str = app_keys[0].key if app_keys else ""
            print(f"[INFO]   {app.name} (id={app.id}) key={key_str}")
        return 0
    app = apps.get_by_name(args.name)
    if app is None:
        print(f"[ERROR] App {args.name} does not exist.")
        return 1
    if args.app_command == "show":
        print(f"[INFO]     App Name: {app.name}")
        print(f"[INFO]       App ID: {app.id}")
        print(f"[INFO]  Description: {app.description or ''}")
        for k in keys.get_by_app_id(app.id):
            allowed = ",".join(k.events) if k.events else "(all)"
            print(f"[INFO]   Access Key: {k.key} | {allowed}")
        for c in channels.get_by_app_id(app.id):
            print(f"[INFO]      Channel: {c.name} (id={c.id})")
        return 0
    if args.app_command == "delete":
        for c in channels.get_by_app_id(app.id):
            events.remove(app.id, c.id)
            channels.delete(c.id)
        events.remove(app.id)
        for k in keys.get_by_app_id(app.id):
            keys.delete(k.key)
        apps.delete(app.id)
        print(f"[INFO] App {args.name} deleted.")
        return 0
    if args.app_command == "data-delete":
        channel_id = None
        if args.channel:
            chan = find_channel(storage, app.id, args.channel)
            if chan is None:
                print(f"[ERROR] Channel {args.channel} does not exist.")
                return 1
            channel_id = chan.id
        events.remove(app.id, channel_id)
        events.init(app.id, channel_id)
        print(f"[INFO] Data of app {args.name} deleted.")
        return 0
    if args.app_command == "channel-new":
        channel_id = channels.insert(Channel(0, args.channel, app.id))
        if channel_id is None:
            print(f"[ERROR] Invalid channel name: {args.channel}")
            return 1
        events.init(app.id, channel_id)
        print(f"[INFO] Channel {args.channel} (id={channel_id}) created.")
        return 0
    # channel-delete
    chan = find_channel(storage, app.id, args.channel)
    if chan is None:
        print(f"[ERROR] Channel {args.channel} does not exist.")
        return 1
    events.remove(app.id, chan.id)
    channels.delete(chan.id)
    print(f"[INFO] Channel {args.channel} deleted.")
    return 0


def _cmd_accesskey(args, storage: Storage) -> int:
    apps = storage.get_meta_data_apps()
    keys = storage.get_meta_data_access_keys()
    if args.ak_command == "new":
        app = apps.get_by_name(args.app_name)
        if app is None:
            print(f"[ERROR] App {args.app_name} does not exist.")
            return 1
        key = keys.insert(AccessKey(args.access_key or "", app.id, tuple(args.event or ())))
        if key is None:
            print(f"[ERROR] Access key {args.access_key} already exists.")
            return 1
        print(f"[INFO] Created new access key: {key}")
        return 0
    if args.ak_command == "delete":
        keys.delete(args.key)
        print(f"[INFO] Deleted access key {args.key}")
        return 0
    # list
    app = apps.get_by_name(args.app_name) if args.app_name else None
    for k in keys.get_all():
        if args.app_name and (app is None or k.appid != app.id):
            continue
        allowed = ",".join(k.events) if k.events else "(all)"
        print(f"[INFO]   {k.key} | app={k.appid} | {allowed}")
    return 0


def _resolve_app_channel(storage: Storage, app_id: int, channel_name: str | None):
    """(ok, channel id) for ``--appid``/``--channel``: an unknown app or
    channel is an error, never a new orphan event table."""
    if storage.get_meta_data_apps().get(app_id) is None:
        print(f"[ERROR] App id {app_id} does not exist.")
        return False, None
    if channel_name is None:
        return True, None
    chan = find_channel(storage, app_id, channel_name)
    if chan is None:
        print(f"[ERROR] Channel {channel_name} does not exist.")
        return False, None
    return True, chan.id


_NO_PYARROW = ("[ERROR] Parquet support requires pyarrow "
               "(pip install 'predictionio-tpu[parquet]').")


def _cmd_export(args, storage: Storage) -> int:
    from predictionio_tpu_torch.tools.export_import import export_events, export_events_parquet

    ok, channel_id = _resolve_app_channel(storage, args.appid, args.channel)
    if not ok:
        return 1
    if args.format == "parquet":
        try:
            n = export_events_parquet(storage, args.appid, args.output, channel_id)
        except ImportError:
            print(_NO_PYARROW)
            return 1
    else:
        with open(args.output, "w") as f:
            n = export_events(storage, args.appid, f, channel_id)
    print(f"[INFO] Exported {n} events to {args.output}")
    return 0


def _cmd_import(args, storage: Storage) -> int:
    from predictionio_tpu_torch.tools.export_import import (
        ImportFormatError,
        import_events,
        import_events_parquet,
    )

    ok, channel_id = _resolve_app_channel(storage, args.appid, args.channel)
    if not ok:
        return 1
    if not os.path.exists(args.input):
        print(f"[ERROR] {args.input} not found.")
        return 1
    fmt = args.format or ("parquet" if args.input.endswith(".parquet") else "json")
    try:
        if fmt == "parquet":
            n = import_events_parquet(storage, args.appid, args.input, channel_id)
        else:
            with open(args.input) as f:
                n = import_events(storage, args.appid, f, channel_id)
    except ImportFormatError as e:
        print(f"[ERROR] {args.input}: {e}")
        return 1
    except ImportError:
        print(_NO_PYARROW)
        return 1
    print(f"[INFO] Imported {n} events from {args.input}")
    return 0


def _cmd_eventserver(args, storage: Storage) -> int:
    from predictionio_tpu_torch.api.event_server import EventServer, EventServerConfig
    from predictionio_tpu_torch.api.http_base import serve_until_stopped

    # an absent flag leaves the PIO_EVENTSERVER_WAL_* default
    wal_overrides = {k: v for k, v in {
        "wal_dir": args.wal_dir,
        "wal_fsync": args.wal_fsync,
        "wal_max_bytes": args.wal_max_bytes,
        "wal_policy": args.wal_policy,
    }.items() if v is not None}
    server = EventServer(storage, EventServerConfig(
        ip=args.ip, port=args.port, stats=args.stats, tracing=args.tracing,
        access_log=args.access_log, **wal_overrides)).start()
    print(f"[INFO] Event Server listening on {args.ip}:{server.port}", flush=True)
    if server.service.wal is not None:
        cfg = server.service.config
        print(f"[INFO] Durable ingest: WAL at {cfg.wal_dir} "
              f"(fsync={cfg.wal_fsync}, budget={cfg.wal_max_bytes} bytes, "
              f"policy={cfg.wal_policy}, "
              f"{server.service.wal.pending_records()} pending)", flush=True)
    serve_until_stopped(server)
    return 0


def _cmd_wal(args, storage: Storage | None) -> int:
    """``status``: a scan that changes nothing (safe against a running
    server); ``replay``: drain into storage in the foreground (with the
    owning event server stopped: opening the journal recovers it);
    ``dead-letter``: show or requeue quarantined records."""
    from predictionio_tpu_torch.data.wal import WalDrainer, WalError, WriteAheadLog, scan_status

    wal_dir = args.wal_dir or os.environ.get("PIO_EVENTSERVER_WAL_DIR") or None
    if not wal_dir:
        print("[ERROR] --wal-dir (or PIO_EVENTSERVER_WAL_DIR) is required.")
        return 1
    try:
        if args.wal_command == "status":
            doc = scan_status(wal_dir)
            if args.format == "json":
                print(json.dumps(doc, indent=2))
                return 0
            print(f"[INFO] WAL at {doc['dir']}")
            print(f"[INFO]   pending: {doc['depth']} record(s), "
                  f"{doc['bytes']} byte(s) in {doc['segments']} segment(s)")
            print(f"[INFO]   cursor: segment {doc['cursor']['segment']} "
                  f"offset {doc['cursor']['offset']} "
                  f"({doc['replayedTotal']} replayed lifetime)")
            print(f"[INFO]   dead letters: {doc['deadLetterPending']} "
                  f"pending ({doc['deadLetterTotal']} lifetime), "
                  f"corrupt: {doc['corruptRecords']}")
            if doc["tornTail"]:
                print("[WARN]   torn tail detected (crash artifact; "
                      "recovered on next server start or replay)")
            return 0
        if args.wal_command == "replay":
            storage = storage or Storage()
            wal = WriteAheadLog(wal_dir)
            drainer = WalDrainer(wal, storage.get_events().insert_batch,
                                 max_replay_attempts=args.max_attempts)
            print(f"[INFO] replaying {wal.pending_records()} journaled record(s) "
                  f"from {wal_dir} ...")
            while True:
                verdict = drainer.drain_once()
                if verdict == "empty":
                    break
                if verdict == "unavailable":
                    print("[ERROR] storage unavailable "
                          f"({wal.pending_records()} record(s) still "
                          "pending) — fix the backend and re-run.")
                    return 1
                # "progress" and "blocked" go on: a blocked record moves
                # to the dead-letter series after --max-attempts passes
            stats = wal.stats()
            wal.close()
            print(f"[INFO] replay complete: {stats['replayedTotal']} "
                  f"replayed lifetime, {stats['deadLetterTotal']} "
                  f"dead-letter record(s).")
            return 0
        # dead-letter
        wal = WriteAheadLog(wal_dir)
        try:
            if args.requeue:
                n, kept = wal.requeue_dead_letters()
                print(f"[INFO] requeued {n} dead-letter record(s) "
                      "into the journal; run `pio wal replay` (or "
                      "start the event server) to drain them.")
                if kept:
                    print(f"[WARN] kept {kept} undecodable "
                          "envelope(s) in the dead-letter series "
                          "(inspect with `pio wal dead-letter`).")
                return 0
            shown = 0
            for env_doc in wal.dead_letters():
                if shown >= args.show:
                    print(f"[INFO] ... (--show {args.show} cap; "
                          "use --show N for more)")
                    break
                print(json.dumps(env_doc))
                shown += 1
            if shown == 0:
                print("[INFO] no dead-letter records.")
            return 0
        finally:
            wal.close()
    except WalError as exc:
        print(f"[ERROR] {exc}")
        return 1


def _cmd_train(args, storage: Storage) -> int:
    from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams
    from predictionio_tpu_torch.workflow.engine_json import load_variant
    from predictionio_tpu_torch.workflow.train import format_stage_times, run_train

    try:
        variant = load_variant(args.engine_json, args.engine_factory)
    except FileNotFoundError:
        print(f"[ERROR] {args.engine_json} not found and no --engine-factory given.")
        return 1
    except json.JSONDecodeError as exc:
        print(f"[ERROR] {args.engine_json} is not valid JSON: {exc}")
        return 1
    except ValueError as exc:
        print(f"[ERROR] {exc}")
        return 1
    wp = WorkflowParams(
        batch=args.batch,
        save_model=not args.no_save_model,
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
    )
    profiler = None
    if args.profile or args.profile_dir:
        from predictionio_tpu_torch.obs.device import TrainProfiler

        profiler = TrainProfiler(profile_dir=args.profile_dir or None)
    outcome = run_train(variant=variant, workflow_params=wp, storage=storage,
                        ctx=EngineContext(wp, storage, device=args.device), profiler=profiler)
    print(f"[INFO] Training finished: engine instance {outcome.instance_id} "
          f"({outcome.status})")
    if outcome.stage_seconds:
        print(f"[INFO] Stage times: {format_stage_times(outcome.stage_seconds)}")
    if outcome.report is not None:
        from predictionio_tpu_torch.obs.device import summarize_train_report

        print(f"[INFO] Train profile: {summarize_train_report(outcome.report)}")
        try:
            with open(args.profile_out, "w") as f:
                json.dump(outcome.report, f, indent=2)
        except OSError as e:
            # the run completed and persisted: an unwritable report path
            # must not turn it into a failing exit code
            print(f"[WARN] could not write {args.profile_out}: {e}")
        else:
            print(f"[INFO] Train report written to {args.profile_out}")
        if args.profile_dir:
            print(f"[INFO] torch.profiler trace in {args.profile_dir}")
    return 0 if outcome.status in ("COMPLETED", "INTERRUPTED") else 1


def _cmd_eval(args, storage: Storage) -> int:
    from predictionio_tpu_torch.workflow.context import EngineContext, WorkflowParams
    from predictionio_tpu_torch.workflow.evaluation import run_evaluation

    generator = args.params_generator or _default_generator(args.evaluation)
    wp = WorkflowParams(batch=args.batch)
    try:
        outcome = run_evaluation(
            args.evaluation,
            generator,
            workflow_params=wp,
            storage=storage,
            ctx=EngineContext(wp, storage, device=args.device),
            parallel=args.parallel,
        )
    except Exception as exc:
        # the instance row already says FAILED (workflow/evaluation.py)
        print(f"[ERROR] Evaluation failed: {exc}")
        return 1
    print(f"[INFO] Evaluation finished: instance {outcome.instance_id}")
    print(f"[INFO] {outcome.result.to_one_liner()}")
    return 0


def _default_generator(evaluation_spec: str):
    """When no generator spec is given, the first EngineParamsGenerator
    subclass or instance in the evaluation's module (the reference
    required both classes; this is a convenience on top)."""
    import importlib

    from predictionio_tpu_torch.controller.evaluation import EngineParamsGenerator
    from predictionio_tpu_torch.utils.reflection import resolve_attr

    evaluation = resolve_attr(evaluation_spec)
    module = importlib.import_module(type(evaluation).__module__
                                     if not isinstance(evaluation, type)
                                     else evaluation.__module__)
    for name in dir(module):
        obj = getattr(module, name)
        if isinstance(obj, EngineParamsGenerator):
            return obj
        if (isinstance(obj, type) and issubclass(obj, EngineParamsGenerator)
                and obj is not EngineParamsGenerator):
            return obj()
    raise ValueError(
        f"no EngineParamsGenerator found in {module.__name__}; "
        "pass one explicitly: pio eval <evaluation> <generator>"
    )


#: the start method of every pool sibling, first start and respawn
#: alike: a respawn comes from a parent whose CUDA is up, which a forked
#: child cannot use, and a parent that ran torch CPU ops leaves a dead
#: OpenMP pool to a forked child
POOL_START_METHOD = "spawn"


def resolve_concrete_port(ip: str, port: int) -> int:
    """A concrete listen port for a worker pool: every ``SO_REUSEPORT``
    sibling must bind the SAME number, so an ephemeral request (port 0)
    is resolved by a throwaway bind before any worker starts."""
    import socket

    if port:
        return port
    probe = socket.socket()
    probe.bind((ip, 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _load_kernels(device: str | None) -> None:
    """On the card, load every kernel library: a worker that cannot
    fails at start, before it serves anything. The deploy process built
    them before the pool started, so a worker builds none."""
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.utils.device import resolve_device

    if resolve_device(device).type == "cuda":
        for name in _build.kernel_names():
            _build.load_kernel_library(name)


def _deploy_worker(config) -> None:
    """One sibling of `pio deploy --workers N`: a whole engine server on
    the shared port, with its own storage connection, CUDA context and
    model replica. Started from the ``spawn`` context; an error exits it
    non-zero (it never serves on another device than its config's)."""
    from predictionio_tpu_torch.api.engine_server import create_engine_server
    from predictionio_tpu_torch.api.http_base import serve_until_stopped
    from predictionio_tpu_torch.serving.placement import apply_worker_affinity

    # before the model loads, so its pages fault in on the pinned cores;
    # the stripe is carved from the deploy process's snapshot of the
    # allowed CPUs (a respawn inherits the parent's already-pinned mask)
    apply_worker_affinity(config.worker_index, max(1, config.workers),
                          cpus=config.cpu_allowlist)
    _load_kernels(config.device)
    serve_until_stopped(create_engine_server(storage=Storage(), config=config).start())


def _cmd_deploy(args, storage: Storage) -> int:
    import dataclasses

    from predictionio_tpu_torch.api.engine_server import create_engine_server
    from predictionio_tpu_torch.api.http_base import serve_until_stopped
    from predictionio_tpu_torch.workflow.deploy import ServerConfig
    from predictionio_tpu_torch.workflow.engine_json import read_variant

    try:
        variant = read_variant(args.engine_json)
    except json.JSONDecodeError as exc:
        print(f"[ERROR] {args.engine_json} is not valid JSON: {exc}")
        return 1
    if args.model_mmap:
        # before any model load, and inherited by every sibling: the
        # workers map one checkpoint's pages instead of holding N copies
        os.environ["PIO_CHECKPOINT_MMAP"] = "r"
    config = ServerConfig(
        ip=args.ip,
        port=args.port,
        engine_instance_id=args.engine_instance_id,
        engine_id=variant.get("id"),
        engine_version=variant.get("version"),
        engine_variant=variant.get("variantId"),
        device=args.device,
        feedback=args.feedback,
        event_server_ip=args.event_server_ip,
        event_server_port=args.event_server_port,
        access_key=args.accesskey,
        server_key=args.server_key,
        tracing=args.tracing,
        access_log=args.access_log,
        # an absent flag leaves ServerConfig's PIO_SERVING_* default
        **{k: v for k, v in {
            "batching": args.batching,
            "batch_policy": args.batch_policy,
            "batch_max": args.batch_max,
            "batch_wait_ms": args.batch_wait_ms,
            # --shm-cache without --cache means a cache, shared
            "cache_enabled": True if args.cache is None and args.shm_cache else args.cache,
            "cache_max_entries": args.cache_max_entries,
            "cache_ttl_s": args.cache_ttl_s,
            "shm_cache": args.shm_cache,
            "shm_slots": args.shm_slots,
            "shm_slot_bytes": args.shm_slot_bytes,
            "request_deadline_ms": args.request_deadline_ms,
            "retrieval": args.retrieval,
            "ann_nlist": args.ann_nlist,
            "ann_nprobe": args.ann_nprobe,
            "ann_rescore": args.ann_rescore,
            "workers": args.workers,
            "online": args.online,
            "online_interval_s": args.online_interval_s,
            "online_overlay_max": args.online_overlay_max,
            "online_state_dir": args.online_state_dir,
        }.items() if v is not None},
    )
    workers = max(1, config.workers)
    if workers == 1:
        if args.supervise:
            print("[WARN] --supervise has no effect with --workers 1 (it respawns "
                  "worker siblings); use an external supervisor for a single process.")
        server = create_engine_server(storage=storage, config=config).start()
        print(f"[INFO] Engine instance {server.deployed.instance_id} listening on "
              f"{args.ip}:{server.port}", flush=True)
        serve_until_stopped(server)
        return 0
    return _deploy_pool(args, storage, dataclasses.replace(
        config, port=resolve_concrete_port(config.ip, config.port), reuse_port=True),
        workers)


def _deploy_pool(args, storage: Storage, config, workers: int) -> int:
    """The prefork pool: this process is worker 0, and N-1 siblings from
    the ``spawn`` context share its ``SO_REUSEPORT`` port; the spool
    directory carries their peering and shared admin state, and the
    shared cache segment belongs to this process. Both are removed here
    when the pool stops."""
    import dataclasses
    import multiprocessing
    import shutil
    import signal
    import tempfile

    from predictionio_tpu_torch.api.engine_server import create_engine_server
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.serving.placement import apply_worker_affinity
    from predictionio_tpu_torch.utils.device import resolve_device

    if resolve_device(config.device).type == "cuda":
        # one nvcc per kernel HERE, before any worker exists (nvcc is a
        # subprocess: no CUDA is initialized), so no worker builds
        _build.build_all()
    config = dataclasses.replace(
        config, worker_spool_dir=tempfile.mkdtemp(prefix="pio-deploy-workers-"))
    # ONE shared-cache segment for the pool, created and owned here;
    # where that fails the workers keep private caches
    shm_owner = None
    if config.shm_cache and config.cache_enabled and not config.shm_segment:
        from predictionio_tpu_torch.serving.shm_cache import ShmResultCache

        segment = f"pio-shm-{os.getpid()}"
        try:
            shm_owner = ShmResultCache(segment, nslots=config.shm_slots,
                                       slot_bytes=config.shm_slot_bytes,
                                       ttl_s=config.cache_ttl_s, create="create")
            config = dataclasses.replace(config, shm_segment=segment)
        except Exception as exc:
            print(f"[WARN] shared-memory cache unavailable ({type(exc).__name__}: {exc}); "
                  "workers fall back to private result caches")
            config = dataclasses.replace(config, shm_cache=False)
    # the pool's allowed CPUs, captured BEFORE this process pins itself
    # to stripe 0: a respawn must carve its stripe from the whole set
    getaffinity = getattr(os, "sched_getaffinity", None)
    try:
        allowed = tuple(sorted(getaffinity(0))) if getaffinity is not None else None
    except OSError:
        allowed = None
    config = dataclasses.replace(config, cpu_allowlist=allowed)
    spawn = multiprocessing.get_context(POOL_START_METHOD)

    def sibling(index: int):
        return spawn.Process(target=_deploy_worker,
                             args=(dataclasses.replace(config, worker_index=index),),
                             name=f"pio-deploy-worker-{index}", daemon=True)

    # a SIGTERM must tear the pool down even during the model load
    def _on_sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _on_sigterm)
    supervisor = None
    procs: list = []
    server = None
    try:
        if args.supervise:
            from predictionio_tpu_torch.fleet.supervisor import (
                WORKER,
                FleetSupervisor,
                ProcessHandle,
                SpawnSpec,
            )

            supervisor = FleetSupervisor([
                SpawnSpec(id=f"worker:{i}", spawn=lambda i=i: ProcessHandle(sibling(i)),
                          role=WORKER)
                for i in range(1, workers)])
            supervisor.start()
        else:
            for i in range(1, workers):
                proc = sibling(i)
                proc.start()
                procs.append(proc)
        apply_worker_affinity(0, workers, cpus=config.cpu_allowlist)
        _load_kernels(config.device)
        server = create_engine_server(storage=storage, config=config).start()
        print(f"[INFO] Engine instance {server.deployed.instance_id} listening on "
              f"{args.ip}:{server.port} ({workers} worker(s)"
              + (", supervised" if supervisor is not None else "") + ")", flush=True)
        server.stopped.wait()
    except KeyboardInterrupt:
        pass
    finally:
        # a second SIGTERM must not cut the teardown short: the spool and
        # the segment would outlive the pool
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        if supervisor is not None:
            supervisor.shutdown()
        if server is not None:
            server.stop()
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.join(timeout=5)
        # the siblings' spool entries outlive a kill; the directory and
        # the segment are this process's
        shutil.rmtree(config.worker_spool_dir, ignore_errors=True)
        if shm_owner is not None:
            shm_owner.close(unlink=True)
    return 0


def _router_worker(config) -> None:
    """One extra `pio router --workers N` worker process: a full
    RouterServer on the shared SO_REUSEPORT listen port. Started from the
    ``spawn`` context (``POOL_START_METHOD``), so the target is
    module-level and ``config`` pickles. A ``POST /stop`` that the
    kernel hands to this worker stops the whole router: it goes to the
    parent as SIGTERM, whose drain stops every worker (under
    ``--supervise`` the worker would otherwise be respawned and the
    router would never stop)."""
    import os
    import signal

    from predictionio_tpu_torch.api.http_base import serve_until_stopped
    from predictionio_tpu_torch.api.router_server import RouterServer

    parent = os.getppid()
    server = RouterServer(config)
    server.service.on_stop = lambda: os.kill(parent, signal.SIGTERM)
    serve_until_stopped(server.start())


def _scaling_requested(args) -> bool:
    return any(v is not None for v in (
        args.min_replicas, args.max_replicas, args.scale_interval_s,
        args.scale_pressure_up, args.scale_burn_up,
        args.scale_up_sustain_s, args.scale_down_sustain_s,
        args.scale_cooldown_s)) or args.scale_dry_run


def _cmd_router(args, storage: Storage) -> int:
    """`pio router` — the fleet tier (docs/fleet.md): a thin router
    fronting N engine-server replicas with health-driven membership,
    weighted canary rollout, hedged retries, and bounded admission.
    With ``--supervise`` the router also OWNS its children: worker
    siblings and ``--replica-cmd`` replicas are respawned on death with
    damped backoff (crash loops latch instead of spinning), SIGTERM
    drains the whole fleet, and the scale controller
    (``--min-replicas``/``--max-replicas``/``--scale-*``) adds/removes
    replicas against the autoscaling signals. Storage-free: the router
    talks HTTP to its replicas, never to the event/metadata stores."""
    import dataclasses
    import itertools
    import shlex
    import subprocess

    from predictionio_tpu_torch.api.router_server import RouterServer
    from predictionio_tpu_torch.fleet.router import RouterConfig

    supervise = args.supervise
    scaling = _scaling_requested(args)
    replica_cmd = args.replica_cmd
    if (replica_cmd is not None or scaling) and not supervise:
        print("[ERROR] --replica-cmd and --min/--max-replicas/--scale-* "
              "require --supervise (the supervisor owns the replicas "
              "the controller scales).")
        return 1

    # template replicas (docs/fleet.md "Supervision"): {port} in the
    # command is substituted per replica; ports allocate sequentially
    # from --replica-port-base for initial AND scale-up spawns
    replica_specs = []
    next_replica_spec = None
    if replica_cmd is not None:
        from predictionio_tpu_torch.fleet.supervisor import REPLICA, SpawnSpec

        port_counter = itertools.count(args.replica_port_base)

        def next_replica_spec(_index=None):
            port = next(port_counter)
            argv = [a.format(port=port)
                    for a in shlex.split(replica_cmd)]
            return SpawnSpec(
                id=f"replica:{port}",
                spawn=lambda: subprocess.Popen(argv),
                role=REPLICA,
                address=f"127.0.0.1:{port}")

        min_replicas = args.min_replicas if args.min_replicas is not None \
            else 1
        initial = args.replicas if args.replicas is not None \
            else max(1, min_replicas)
        replica_specs = [next_replica_spec() for _ in range(initial)]

    # named engine groups (docs/fleet.md "Multi-engine routing"):
    # each --engine declares an independent backend group with its own
    # membership/breakers/canary/quota; replicas=N spawns supervised
    # engine replicas from the --replica-cmd template on ports from
    # that engine's port-base
    engine_specs = []
    engine_replica_specs: list[tuple[str, object]] = []
    if args.engine:
        from predictionio_tpu_torch.fleet.gateway import (
            EngineSpec,
            parse_engine_flag,
        )

        try:
            flags = [parse_engine_flag(text) for text in args.engine]
        except ValueError as exc:
            print(f"[ERROR] {exc}")
            return 1
        for flag in flags:
            spawned: list[str] = []
            if flag["replicas"]:
                if replica_cmd is None or not supervise:
                    print(f"[ERROR] --engine {flag['name']}: replicas= "
                          "requires --supervise --replica-cmd (the "
                          "supervisor owns engine replicas).")
                    return 1
                if flag["port_base"] is None:
                    print(f"[ERROR] --engine {flag['name']}: replicas= "
                          "needs port-base= (each engine owns its own "
                          "port range).")
                    return 1
                from predictionio_tpu_torch.fleet.supervisor import (
                    REPLICA,
                    SpawnSpec,
                )

                for i in range(flag["replicas"]):
                    port = flag["port_base"] + i
                    argv = [a.format(port=port)
                            for a in shlex.split(replica_cmd)]
                    engine_replica_specs.append((flag["name"], SpawnSpec(
                        id=f"replica:{flag['name']}:{port}",
                        spawn=(lambda argv=argv:
                               subprocess.Popen(argv)),
                        role=REPLICA,
                        address=f"127.0.0.1:{port}")))
                    spawned.append(f"127.0.0.1:{port}")
            try:
                engine_specs.append(EngineSpec(
                    name=flag["name"],
                    backends=flag["backends"] + tuple(spawned),
                    canary_backends=flag["canary_backends"],
                    canary_weight_pct=flag["weight"] or 0.0,
                    quota_qps=flag["qps"],
                    quota_burst=flag["burst"],
                    max_inflight=flag["max_inflight"],
                    burst_credits=flag["credits"],
                    min_replicas=flag["min_replicas"],
                    max_replicas=flag["max_replicas"]))
            except ValueError as exc:
                print(f"[ERROR] {exc}")
                return 1
        if any(f["min_replicas"] is not None
               or f["max_replicas"] is not None for f in flags):
            # per-engine bounds arm scaling like the global flags do
            if not supervise:
                print("[ERROR] --engine min-replicas=/max-replicas= "
                      "require --supervise (the supervisor owns the "
                      "replicas the per-engine controllers scale).")
                return 1
            scaling = True

    backends = tuple(args.backend or ()) + tuple(
        s.address for s in replica_specs)
    if not backends and not engine_specs:
        print("[ERROR] at least one --backend host:port, --engine "
              "name=...,backend=..., or --supervise --replica-cmd is "
              "required.")
        return 1
    workers = max(1, args.workers or 1)
    config = RouterConfig(
        ip=args.ip,
        port=args.port,
        backends=backends,
        canary_backends=tuple(args.canary_backend or ()),
        engines=tuple(engine_specs),
        router_key=args.router_key,
        access_log=args.access_log,
        tracing=args.tracing,
        reuse_port=workers > 1,
        **{k: v for k, v in {
            "probe_interval_s": args.probe_interval_s,
            "probe_timeout_s": args.probe_timeout_s,
            "down_after": args.down_after,
            "up_after": args.up_after,
            "max_inflight": args.max_inflight,
            "request_deadline_ms": args.request_deadline_ms,
            "hedge": args.hedge,
            "canary_weight_pct": args.canary_weight,
            "default_engine": args.default_engine,
        }.items() if v is not None},
    )
    worker_procs = []
    worker_specs = []
    if workers > 1:
        import multiprocessing
        import tempfile

        spawn = multiprocessing.get_context(POOL_START_METHOD)

        config = dataclasses.replace(
            config, port=resolve_concrete_port(config.ip, config.port))
        # worker peering spool (fleet/workers.py): each worker
        # registers its loopback peer endpoint here, so a /metrics
        # scrape landing on ONE SO_REUSEPORT worker reports ALL of
        # them — and the shared canary/admin state document rides the
        # same spool (docs/fleet.md)
        config = dataclasses.replace(
            config,
            worker_spool_dir=tempfile.mkdtemp(prefix="pio-router-workers-"))
        if supervise:
            from predictionio_tpu_torch.fleet.supervisor import (
                WORKER,
                ProcessHandle,
                SpawnSpec,
            )

            def worker_spawn():
                return ProcessHandle(spawn.Process(
                    target=_router_worker, args=(config,), daemon=True))

            worker_specs = [
                SpawnSpec(id=f"worker:{i}", spawn=worker_spawn,
                          role=WORKER)
                for i in range(1, workers)
            ]
        else:
            for _ in range(workers - 1):
                proc = spawn.Process(
                    target=_router_worker, args=(config,), daemon=True)
                proc.start()
                worker_procs.append(proc)

    supervisor = None
    controller = None
    scale_set = None
    if supervise:
        from predictionio_tpu_torch.fleet.supervisor import (
            FleetSupervisor,
            SupervisorConfig,
        )

        supervisor = FleetSupervisor(
            replica_specs + [s for _, s in engine_replica_specs]
            + worker_specs,
            SupervisorConfig(**({"drain_key": args.replica_key}
                                if args.replica_key else {})))
        supervisor.start()
    try:
        server = RouterServer(config)
    except ValueError as exc:
        # gateway-level validation (duplicate --engine name, a name
        # colliding with the default engine built from --backend):
        # a pointed error like every other flag check — and any
        # already-spawned supervised children must not be orphaned
        if supervisor is not None:
            supervisor.shutdown()
        print(f"[ERROR] {exc}")
        return 1
    if supervisor is not None:
        server.service.attach_supervisor(supervisor)
        for engine_name, spec in (
                [(None, s) for s in replica_specs]
                + engine_replica_specs):
            # template replicas are still booting (importing jax):
            # join them DOWN so the probe loop gates traffic onto them
            # when they actually serve — the same invariant the
            # scale-up actuator establishes for identical cold spawns.
            # Engine replicas live in THEIR engine's membership
            group = (server.gateway.get(engine_name)
                     if engine_name else None)
            membership = (group.router.membership if group is not None
                          else server.router.membership)
            backend = membership.by_id(spec.address)
            if backend is not None:
                backend.mark_down("starting")
    if supervise and (scaling or replica_cmd is not None) and engine_specs:
        # per-tenant elasticity (docs/fleet.md "Per-tenant
        # elasticity"): one ScaleController per engine group, each with
        # its own bounds/hysteresis/cooldown, scale-ups arbitrated
        # against the shared --replica-budget. Engines with supervised
        # replicas actuate; engines fronting only static backends run
        # dry (verdicts exported, nothing to spawn).
        import os

        from predictionio_tpu_torch.fleet.controller import (
            CapacityArbiter,
            EngineScaleSet,
            MembershipCountActuator,
            ScalePolicy,
            SupervisedFleetActuator,
            engine_scale_policy,
        )
        from predictionio_tpu_torch.fleet.supervisor import REPLICA, SpawnSpec

        budget = args.replica_budget
        if budget is None:
            raw = os.environ.get("PIO_FLEET_REPLICA_BUDGET")
            try:
                budget = int(raw) if raw else 0
            except ValueError:
                print("[WARN] ignoring unparseable "
                      f"PIO_FLEET_REPLICA_BUDGET={raw!r}")
                budget = 0
        dry_run = bool(args.scale_dry_run) or not scaling
        if dry_run and not args.scale_dry_run:
            print("[INFO] per-engine scale controllers in DRY-RUN (no "
                  "scale bounds given): verdicts exported only; add "
                  "min-replicas=/max-replicas= per engine or --scale-* "
                  "to arm actuation (docs/fleet.md rollout runbook).")
        #: the global --scale-* flags become each tenant's base layer;
        #: PIO_FLEET_ENGINE_<NAME>_* env and per-engine flag keys
        #: override (engine_scale_policy precedence)
        base_policy = {
            "min_replicas": args.min_replicas,
            "max_replicas": args.max_replicas,
            "interval_s": args.scale_interval_s,
            "pressure_up": args.scale_pressure_up,
            "burn_up": args.scale_burn_up,
            "up_sustain_s": args.scale_up_sustain_s,
            "down_sustain_s": args.scale_down_sustain_s,
            "cooldown_s": args.scale_cooldown_s,
        }
        arbiter = CapacityArbiter(budget)
        interval = (args.scale_interval_s
                    if args.scale_interval_s is not None
                    else ScalePolicy().interval_s)
        scale_set = EngineScaleSet(server.service, arbiter,
                                   interval_s=interval)
        supervised: dict[str, list] = {}
        for engine_name, spec in engine_replica_specs:
            supervised.setdefault(engine_name, []).append(spec)
        for flag in flags:
            name = flag["name"]
            group = server.gateway.get(name)
            if group is None:
                continue
            owned = supervised.get(name)
            engine_dry = dry_run
            if owned and replica_cmd is not None:
                # this engine's scale-up ports continue past its
                # initial spawns, inside its own port-base range
                counter = itertools.count(
                    flag["port_base"] + flag["replicas"])

                def make_engine_spec(_index=None, name=name,
                                     counter=counter):
                    port = next(counter)
                    argv = [a.format(port=port)
                            for a in shlex.split(replica_cmd)]
                    return SpawnSpec(
                        id=f"replica:{name}:{port}",
                        spawn=lambda: subprocess.Popen(argv),
                        role=REPLICA,
                        address=f"127.0.0.1:{port}")

                actuator = SupervisedFleetActuator(
                    supervisor, group.router.membership,
                    make_spec=make_engine_spec,
                    breaker_threshold=config.breaker_threshold,
                    breaker_reset_s=config.breaker_reset_s)
                for spec in owned:
                    actuator.adopt(spec.id)
            else:
                actuator = MembershipCountActuator(
                    group.router.membership)
                engine_dry = True
            scale_set.add_engine(
                name,
                engine_scale_policy(
                    name, dry_run=engine_dry, base=base_policy,
                    min_replicas=flag["min_replicas"],
                    max_replicas=flag["max_replicas"]),
                actuator)
        # the default engine built from --backend / --replica-cmd
        # participates too when it exists alongside the named engines
        default_name = server.gateway.default_engine
        if backends and scale_set.get(default_name) is None \
                and server.gateway.get(default_name) is not None:
            engine_dry = dry_run
            if next_replica_spec is not None:
                actuator = SupervisedFleetActuator(
                    supervisor, server.router.membership,
                    make_spec=next_replica_spec,
                    breaker_threshold=config.breaker_threshold,
                    breaker_reset_s=config.breaker_reset_s)
                for spec in replica_specs:
                    actuator.adopt(spec.id)
            else:
                actuator = MembershipCountActuator(
                    server.router.membership)
                engine_dry = True
            scale_set.add_engine(
                default_name,
                engine_scale_policy(default_name, dry_run=engine_dry,
                                    base=base_policy),
                actuator)
        scale_set.start()
        server.service.attach_scale_set(scale_set)
    elif supervise and (scaling or replica_cmd is not None):
        from predictionio_tpu_torch.fleet.controller import (
            MembershipCountActuator,
            ScaleController,
            ScalePolicy,
            SupervisedFleetActuator,
            fleet_signals_reader,
        )

        # actuation must be REQUESTED: --replica-cmd alone runs the
        # controller in dry-run (verdicts exported, nothing spawned) —
        # the documented rollout posture. Passing any --scale-* or
        # --min/--max-replicas flag without --scale-dry-run arms it.
        dry_run = bool(args.scale_dry_run) or not scaling
        if dry_run and not args.scale_dry_run:
            print("[INFO] scale controller in DRY-RUN (no --scale-* "
                  "flags given): verdicts exported only; add "
                  "--min/--max-replicas or --scale-* to arm actuation "
                  "(docs/fleet.md rollout runbook).")
        if next_replica_spec is not None:
            actuator = SupervisedFleetActuator(
                supervisor, server.router.membership,
                make_spec=next_replica_spec,
                breaker_threshold=config.breaker_threshold,
                breaker_reset_s=config.breaker_reset_s)
            for spec in replica_specs:
                actuator.adopt(spec.id)
        else:
            print("[WARN] scale flags without --replica-cmd: the "
                  "controller has nothing to actuate — forcing "
                  "--scale-dry-run (decisions exported only).")
            actuator = MembershipCountActuator(server.router.membership)
            dry_run = True
        policy = ScalePolicy(
            dry_run=dry_run,
            **{k: v for k, v in {
                "min_replicas": args.min_replicas,
                "max_replicas": args.max_replicas,
                "interval_s": args.scale_interval_s,
                "pressure_up": args.scale_pressure_up,
                "burn_up": args.scale_burn_up,
                "up_sustain_s": args.scale_up_sustain_s,
                "down_sustain_s": args.scale_down_sustain_s,
                "cooldown_s": args.scale_cooldown_s,
            }.items() if v is not None})
        controller = ScaleController(
            policy, fleet_signals_reader(server.service), actuator)
        controller.start()
        server.service.attach_controller(controller)
    print(f"[INFO] Fleet Router listening on {args.ip}:{server.port} "
          f"({len(config.backends)} stable / "
          f"{len(config.canary_backends)} canary backend(s), "
          f"{workers} worker(s)"
          + (f", {len(server.gateway.engine_names())} engines "
             f"[default: {server.gateway.default_engine}]"
             if engine_specs else "")
          + (", supervised" if supervise else "")
          + (", scale controller "
             + ("dry-run" if controller is not None
                and controller.policy.dry_run else "active")
             if controller is not None else "")
          + (f", per-engine elasticity x{len(scale_set.controllers())}"
             + (f" budget={scale_set.arbiter.budget}"
                if scale_set.arbiter.budget else "")
             if scale_set is not None else "")
          + ")")
    if worker_procs or supervisor is not None:
        # SIGTERM's default action kills the parent without running
        # finally/atexit, orphaning the SO_REUSEPORT workers on the
        # shared port (they keep serving with a stale spool). Route it
        # through KeyboardInterrupt so the finally always runs — under
        # --supervise that means a graceful FULL-FLEET drain (replicas
        # drained via /readyz before SIGTERM, then workers), fixing
        # the old "stop from the shell stops one worker" quirk.
        import signal

        def _on_sigterm(signum, frame):
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.start()
        server.stopped.wait()
    except KeyboardInterrupt:
        pass
    finally:
        if controller is not None:
            controller.stop()
        if scale_set is not None:
            scale_set.stop()
        if supervisor is not None:
            supervisor.shutdown()
        server.stop()
        for proc in worker_procs:
            proc.terminate()
        for proc in worker_procs:
            proc.join(timeout=5)
        if config.worker_spool_dir:
            # terminate() is SIGTERM: workers die without running
            # WorkerHub.close, leaving their spool entries behind —
            # the parent mkdtemp'd the dir, the parent removes it
            import shutil

            shutil.rmtree(config.worker_spool_dir, ignore_errors=True)
    return 0


def _cmd_trace(args, storage: Storage) -> int:
    """`pio trace <trace_id>` — fetch the stitched cross-process tree
    of one fleet request from the router's merge endpoint
    (GET /traces.json?trace_id=) and render it as a text tree or
    Chrome trace-viewer JSON (docs/observability.md)."""
    import urllib.error
    import urllib.parse
    import urllib.request

    from predictionio_tpu_torch.obs.stitch import render_tree, to_chrome_trace

    url = (f"http://{args.router}/traces.json?"
           f"trace_id={urllib.parse.quote(args.trace_id)}")
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as r:
            doc = json.load(r)
    except urllib.error.HTTPError as e:
        try:
            doc = json.load(e)
        except json.JSONDecodeError:
            doc = {}
        print(f"[ERROR] trace {args.trace_id} not found "
              f"({doc.get('message', f'HTTP {e.code}')})")
        return 1
    except OSError as e:
        print(f"[ERROR] router {args.router} unreachable: {e}")
        return 1
    tree = doc.get("trace")
    if not doc.get("found") or tree is None:
        print(f"[ERROR] trace {args.trace_id} not found")
        return 1
    if args.chrome:
        payload = json.dumps(to_chrome_trace(tree), indent=2)
        if args.out:
            with open(args.out, "w") as f:
                f.write(payload)
            print(f"[INFO] Chrome trace written to {args.out} "
                  f"(open chrome://tracing or ui.perfetto.dev)")
        else:
            print(payload)
    else:
        print(render_tree(tree))
        if doc.get("scrapeErrors"):
            print(f"[WARN] {doc['scrapeErrors']} replica trace ring(s) "
                  "unreachable; the tree may be missing segments")
    return 0


def _git_changed_relpaths(pkg: str) -> set[str]:
    """Package-relative paths of .py files git sees as modified, staged
    or untracked — the `pio lint --changed` reporting scope. Raises
    RuntimeError when git is unavailable (the caller exits 2: a CI hook
    must fail loudly, not silently lint nothing)."""
    import subprocess

    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            cwd=pkg, capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"--changed needs git: {exc}")
    if top.returncode != 0:
        raise RuntimeError("--changed: package is not inside a git work tree")
    root = top.stdout.strip()
    out = subprocess.run(
        ["git", "status", "--porcelain", "--untracked-files=all"],
        cwd=root, capture_output=True, text=True, timeout=10)
    if out.returncode != 0:
        raise RuntimeError(
            f"--changed: git status failed: {out.stderr.strip()}")
    changed: set[str] = set()
    for line in out.stdout.splitlines():
        if len(line) < 4:
            continue
        path = line[3:]
        if " -> " in path:  # rename: the new side is what gets linted
            path = path.split(" -> ", 1)[1]
        path = path.strip().strip('"')
        if not path.endswith(".py"):
            continue
        abspath = os.path.abspath(os.path.join(root, path))
        if abspath.startswith(pkg + os.sep):
            changed.add(os.path.relpath(abspath, pkg).replace(os.sep, "/"))
    return changed


def _cmd_lint(args, storage: Storage | None) -> int:
    """`pio lint` — AST invariant checker for the serving/compute paths
    (``analysis/``), over this package unless paths are given. Exit 0
    clean, 1 on findings, 2 on a bad invocation. Imports no torch."""
    import predictionio_tpu_torch
    from predictionio_tpu_torch.analysis import (
        all_rules,
        default_config,
        format_findings,
        lint_paths_report,
    )

    if args.list_rules:
        policy = default_config()
        for rule_id, rule in sorted(all_rules().items()):
            # the EFFECTIVE repo-policy scope, not the rule's built-in
            # default — the listing must match what a run checks
            paths = ", ".join(p or "<all>" for p in policy.rule_paths(rule))
            print(f"{rule_id:24s} {rule.description} [{paths}]")
        return 0

    pkg = os.path.dirname(os.path.abspath(predictionio_tpu_torch.__file__))
    changed = None
    if args.changed:
        try:
            changed = _git_changed_relpaths(pkg)
        except RuntimeError as exc:
            print(f"[ERROR] {exc}", file=sys.stderr)
            return 2
    cache = None
    if not args.no_cache:
        from predictionio_tpu_torch.analysis.cache import (
            LintCache,
            default_cache_path,
            rules_fingerprint,
        )

        cache = LintCache(default_cache_path(pkg),
                          rules_fingerprint(default_config(), args.rules))
    project = not args.no_project

    try:
        if not args.paths:
            findings, stats = lint_paths_report(
                [pkg], rel_root=pkg, rule_ids=args.rules, cache=cache,
                project=project, changed=changed)
        else:
            # paths inside the package keep the policy's package-relative
            # scoping; ad-hoc files outside it (fixtures, snippets) run
            # every requested rule unscoped — `pio lint some_file.py
            # --rule X` must never silently skip X for scope reasons
            in_pkg = [
                p for p in args.paths
                if os.path.abspath(p) == pkg
                or os.path.abspath(p).startswith(pkg + os.sep)
            ]
            external = [p for p in args.paths if p not in in_pkg]
            findings, stats = [], None
            if in_pkg:
                findings, stats = lint_paths_report(
                    in_pkg, rel_root=pkg, rule_ids=args.rules, cache=cache,
                    project=project, changed=changed)
            if external:
                ext_findings, ext_stats = lint_paths_report(
                    external, config=default_config().unscoped(),
                    rule_ids=args.rules, project=project)
                findings += ext_findings
                stats = _merge_lint_stats(stats, ext_stats)
            findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    except (KeyError, OSError) as exc:
        # stderr: stdout must stay machine-parseable under --format json
        print(f"[ERROR] {exc.args[0] if isinstance(exc, KeyError) else exc}",
              file=sys.stderr)
        return 2

    from predictionio_tpu_torch.analysis.report import (
        apply_baseline,
        load_baseline,
        write_baseline,
    )

    if args.write_baseline:
        n = write_baseline(args.write_baseline, findings)
        print(f"[INFO] wrote {n} finding(s) to {args.write_baseline}",
              file=sys.stderr)
        return 0
    if args.baseline:
        try:
            accepted = load_baseline(args.baseline)
        except (OSError, ValueError) as exc:
            print(f"[ERROR] {exc}", file=sys.stderr)
            return 2
        findings, suppressed = apply_baseline(findings, accepted)
        if suppressed:
            print(f"[INFO] baseline suppressed {suppressed} finding(s)",
                  file=sys.stderr)
    print(format_findings(
        findings, fmt=args.format,
        stats=stats if args.format == "json" else None))
    return 1 if findings else 0


def _merge_lint_stats(a, b):
    """Fold two LintStats (in-package + external path runs) into one
    JSON report; rule lists union, counters and timings add."""
    if a is None:
        return b
    a.files += b.files
    a.cache_hits += b.cache_hits
    a.cache_misses += b.cache_misses
    a.parse_s += b.parse_s
    a.module_rules_s += b.module_rules_s
    a.project_rules_s += b.project_rules_s
    a.total_s += b.total_s
    a.module_rules = sorted(set(a.module_rules) | set(b.module_rules))
    a.project_rules = sorted(set(a.project_rules) | set(b.project_rules))
    return a


def _serve(server, label: str, ip: str) -> int:
    """Start ``server``, print its bound address and block until it stops
    (SIGTERM or Ctrl-C)."""
    from predictionio_tpu_torch.api.http_base import serve_until_stopped

    server.start()
    print(f"[INFO] {label} listening on {ip}:{server.port}", flush=True)
    serve_until_stopped(server)
    return 0


def _configure_dashboard(sub) -> None:
    p = sub.add_parser("dashboard", help="launch the evaluation dashboard")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--access-log", action=argparse.BooleanOptionalAction,
                   default=None, dest="access_log",
                   help="structured JSON access logs")


def _cmd_dashboard(args, storage: Storage) -> int:
    from predictionio_tpu_torch.tools.dashboard import Dashboard

    return _serve(Dashboard(storage, ip=args.ip, port=args.port,
                            access_log=args.access_log),
                  "Dashboard", args.ip)


def _configure_adminserver(sub) -> None:
    p = sub.add_parser("adminserver", help="launch the admin REST API")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7071)


def _cmd_adminserver(args, storage: Storage) -> int:
    from predictionio_tpu_torch.tools.admin import AdminServer

    return _serve(AdminServer(storage, ip=args.ip, port=args.port),
                  "Admin API", args.ip)


def _check_template_min_version(template_json: str = "template.json") -> bool:
    """The template.json ``{"pio": {"version": {"min": "X.Y.Z"}}}`` gate:
    False (with an error printed) when this package is older than the
    template needs."""
    if not os.path.exists(template_json):
        return True
    try:
        with open(template_json) as f:
            spec = json.load(f)
        min_version = spec.get("pio", {}).get("version", {}).get("min")
    except (json.JSONDecodeError, AttributeError):
        print(f"[WARN] {template_json} is malformed; skipping version check.")
        return True
    if not min_version:
        return True

    def vtuple(v):
        return tuple(int(p) for p in str(v).split(".") if p.isdigit())

    if not vtuple(min_version):
        print(f"[WARN] {template_json} min version {min_version!r} is not "
              "a version string; skipping version check.")
        return True
    if vtuple(__version__) < vtuple(min_version):
        print(f"[ERROR] This template requires predictionio_tpu_torch >= "
              f"{min_version} (current: {__version__}).")
        return False
    return True


def _configure_build(sub) -> None:
    p = sub.add_parser("build", help="verify an engine variant is runnable")
    p.add_argument("--engine-json", default="engine.json",
                   help="engine variant file (default: ./engine.json)")
    p.add_argument("--engine-factory", default="",
                   help="override engineFactory from engine.json")


def _cmd_build(args, storage: Storage) -> int:
    """Verify the engine variant: the template version gate, then the
    engineFactory imports, instantiates and binds the variant's params
    (what the reference's sbt build checked). Loads torch only through
    the factory's own imports."""
    from predictionio_tpu_torch.controller.engine import resolve_engine_factory

    if not _check_template_min_version():
        return 1
    variant = {}
    try:
        if os.path.exists(args.engine_json):   # (workflow/ would load torch)
            with open(args.engine_json) as f:
                variant = json.load(f)
    except json.JSONDecodeError as exc:
        print(f"[ERROR] {args.engine_json} is not valid JSON: {exc}")
        return 1
    factory_path = args.engine_factory or variant.get("engineFactory", "")
    if not factory_path:
        if os.path.exists(args.engine_json):
            print(f"[ERROR] {args.engine_json} has no engineFactory and "
                  "no --engine-factory given.")
        else:
            print(f"[ERROR] {args.engine_json} not found and no "
                  "--engine-factory given.")
        return 1
    try:
        engine = resolve_engine_factory(factory_path)()
    except Exception as exc:
        print(f"[ERROR] engineFactory {factory_path!r} failed: {exc}")
        return 1
    try:
        engine.params_from_variant_json(variant)
    except Exception as exc:
        print(f"[ERROR] engine.json params do not bind: {exc}")
        return 1
    print(f"[INFO] Build successful: {factory_path} "
          f"({type(engine).__name__}) binds {args.engine_json}.")
    return 0


def _configure_run(sub) -> None:
    p = sub.add_parser(
        "run", help="run an arbitrary main function with storage wired up")
    p.add_argument("main", help="dotted path module[:function] (default function: main)")
    p.add_argument("args", nargs=argparse.REMAINDER,
                   help="arguments passed through verbatim")


def _cmd_run(args, storage: Storage) -> int:
    """Run ``pkg.module[:function]`` (default ``main``) in this process
    with the storage environment in place; its int result is the exit
    code (True is 0)."""
    import importlib

    target = args.main
    mod_name, _, fn_name = target.partition(":")
    fn_name = fn_name or "main"
    try:
        module = importlib.import_module(mod_name)
        fn = getattr(module, fn_name)
    except (ImportError, AttributeError) as exc:
        print(f"[ERROR] cannot resolve {target!r}: {exc}")
        return 1
    result = fn(*args.args)
    # bool subclasses int; a main returning True means success, not rc=1
    if isinstance(result, bool):
        return 0 if result else 1
    return int(result) if isinstance(result, int) else 0


def _configure_upgrade(sub) -> None:
    sub.add_parser("upgrade", help="(no longer supported)")


def _cmd_upgrade(args, storage: Storage) -> int:
    print("[ERROR] Upgrade is no longer supported")
    return 1


def _configure_template(sub) -> None:
    p = sub.add_parser("template", help="(no longer supported; use git)")
    p.add_argument("subcommand", nargs="*")


def _cmd_template(args, storage: Storage) -> int:
    print("[ERROR] template commands are no longer supported.")
    print("[ERROR] Built-in engine templates live in predictionio_tpu_torch.templates "
          "(recommendation, similarproduct, ecommerce, classification).")
    return 1


def _cmd_undeploy(args, storage: Storage) -> int:
    from predictionio_tpu_torch.api.http_base import undeploy

    if undeploy(args.ip, args.port, args.server_key):
        print(f"[INFO] Undeployed engine server at {args.ip}:{args.port}")
        return 0
    print(f"[ERROR] No engine server running at {args.ip}:{args.port}")
    return 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pio", description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("version", help="show version")
    p = sub.add_parser("status", help="verify environment and storage")
    p.add_argument("--router", default=None, metavar="HOST:PORT",
                   help="inspect a running fleet router instead: print "
                        "its registered engine table (name, group "
                        "sizes, up/down counts, canary weight, quota) "
                        "from GET /fleet/engines — storage-free")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="HTTP timeout for the --router fetch")

    p = sub.add_parser("app", help="app administration")
    app_sub = p.add_subparsers(dest="app_command", required=True)
    pn = app_sub.add_parser("new")
    pn.add_argument("name")
    pn.add_argument("--id", type=int)
    pn.add_argument("--description")
    pn.add_argument("--access-key", dest="access_key")
    app_sub.add_parser("list")
    for name in ("show", "delete"):
        app_sub.add_parser(name).add_argument("name")
    pdd = app_sub.add_parser("data-delete")
    pdd.add_argument("name")
    pdd.add_argument("--channel")
    for name in ("channel-new", "channel-delete"):
        pc = app_sub.add_parser(name)
        pc.add_argument("name")
        pc.add_argument("channel")

    p = sub.add_parser("accesskey", help="access key administration")
    ak_sub = p.add_subparsers(dest="ak_command", required=True)
    an = ak_sub.add_parser("new")
    an.add_argument("app_name")
    an.add_argument("--access-key", dest="access_key")
    an.add_argument("--event", action="append")
    ak_sub.add_parser("list").add_argument("app_name", nargs="?")
    ak_sub.add_parser("delete").add_argument("key")

    p = sub.add_parser("eventserver", help="launch the event server")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7070)
    p.add_argument("--stats", action="store_true")
    p.add_argument("--tracing", action=argparse.BooleanOptionalAction, default=None,
                   help="per-request spans for the ingest paths, served on "
                        "GET /traces.json (absent: PIO_TRACE)")
    p.add_argument("--access-log", action=argparse.BooleanOptionalAction, default=None,
                   dest="access_log",
                   help="structured JSON access logs (absent: PIO_ACCESS_LOG)")
    p.add_argument("--wal-dir", default=None, dest="wal_dir",
                   help="write-ahead journal directory: storage outages ride "
                        "through as 202-journaled events replayed by a background "
                        "drainer (default: WAL off, outages shed 503s)")
    p.add_argument("--wal-fsync", default=None, dest="wal_fsync",
                   choices=("always", "interval", "off"),
                   help="journal fsync policy: always = every 202 is crash-durable; "
                        "interval (default) = bounded loss window; off = OS page "
                        "cache only")
    p.add_argument("--wal-max-bytes", type=int, default=None, dest="wal_max_bytes",
                   help="journal disk budget; past it ingest reverts to 503 "
                        "backpressure with a drain-aware Retry-After")
    p.add_argument("--wal-policy", default=None, dest="wal_policy",
                   choices=("ride-through", "write-through"),
                   help="ride-through (default) journals only during a storage "
                        "outage; write-through journals every event (202) and "
                        "leaves storage to the drainer")

    p = sub.add_parser("wal", help="operate the durable-ingest write-ahead journal")
    wal_sub = p.add_subparsers(dest="wal_command", required=True)
    ws = wal_sub.add_parser("status", help="journal scan that changes nothing "
                                           "(safe against a running event server)")
    ws.add_argument("--wal-dir", default=None, dest="wal_dir",
                    help="journal directory (default: PIO_EVENTSERVER_WAL_DIR)")
    ws.add_argument("--format", choices=("text", "json"), default="text")
    wr = wal_sub.add_parser("replay", help="drain into storage in the foreground, "
                                           "with the owning event server stopped")
    wr.add_argument("--wal-dir", default=None, dest="wal_dir")
    wr.add_argument("--max-attempts", type=int, default=5, dest="max_attempts",
                    help="application-failure passes per record before "
                         "dead-letter quarantine")
    wd = wal_sub.add_parser("dead-letter", help="inspect or requeue quarantined records")
    wd.add_argument("--wal-dir", default=None, dest="wal_dir")
    wd.add_argument("--show", type=int, default=20,
                    help="print at most this many envelopes")
    wd.add_argument("--requeue", action="store_true",
                    help="move every dead-letter record back into the live journal")

    p = sub.add_parser("export", help="export an app's events to a JSON-lines or Parquet file")
    p.add_argument("--appid", type=int, required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--channel", default=None)
    p.add_argument("--format", choices=("json", "parquet"), default="json")
    p = sub.add_parser("import", help="import events from a JSON-lines or Parquet file")
    p.add_argument("--appid", type=int, required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--channel", default=None)
    p.add_argument("--format", choices=("json", "parquet"), default=None,
                   help="default: parquet for .parquet files, else json")

    p = sub.add_parser("train", help="train an engine variant")
    p.add_argument("--engine-json", default="engine.json",
                   help="engine variant file (default: ./engine.json)")
    p.add_argument("--engine-factory", default="",
                   help="override engineFactory from engine.json")
    p.add_argument("--batch", default="", help="batch label")
    p.add_argument("--skip-sanity-check", action="store_true")
    p.add_argument("--stop-after-read", action="store_true")
    p.add_argument("--stop-after-prepare", action="store_true")
    p.add_argument("--no-save-model", action="store_true", dest="no_save_model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile", action="store_true",
                   help="profile the run: per-stage wall/compile/execute split, "
                        "FLOPs, MFU and device memory, written to --profile-out")
    p.add_argument("--profile-dir", default="",
                   help="also write a torch.profiler Chrome trace into this "
                        "directory; implies --profile")
    p.add_argument("--profile-out", default="TRAIN_REPORT.json",
                   help="where --profile writes the report (default: "
                        "./TRAIN_REPORT.json)")

    p = sub.add_parser("eval", help="evaluate an engine over a params grid")
    p.add_argument("evaluation", help="Evaluation class spec, e.g. pkg.mod.MyEval")
    p.add_argument("params_generator", nargs="?", default="",
                   help="EngineParamsGenerator class spec (defaults to the "
                        "evaluation module's own generator if omitted)")
    p.add_argument("--batch", default="")
    p.add_argument("--parallel", type=int, default=None, metavar="N",
                   help="fan grid points over N eval worker processes "
                        "(default: PIO_EVAL_PARALLEL or 1 = sequential)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    p = sub.add_parser("deploy", help="deploy the latest trained engine instance")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--workers", type=int, default=None,
                   help="engine-server processes sharing the listen port via "
                        "SO_REUSEPORT (absent: PIO_SERVING_WORKERS, else 1); /metrics, "
                        "/stats.json and /traces.json report the whole pool from any "
                        "worker, and /reload, /drain and /retrieval reach every sibling")
    p.add_argument("--supervise", action="store_true",
                   help="own the worker siblings: respawn on death with damped "
                        "backoff, latch crash loops, stop the pool on SIGTERM")
    p.add_argument("--model-mmap", action="store_true", dest="model_mmap",
                   help="map npz model checkpoints, so the workers share their host "
                        "pages (sets PIO_CHECKPOINT_MMAP=r; each worker's copy on the "
                        "card is its own)")
    p.add_argument("--engine-instance-id", default=None)
    p.add_argument("--engine-json", default="engine.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--feedback", action="store_true",
                   help="post each query and prediction to the event server")
    p.add_argument("--event-server-ip", default="0.0.0.0")
    p.add_argument("--event-server-port", type=int, default=7070)
    p.add_argument("--accesskey", default="", help="access key for feedback events")
    p.add_argument("--server-key", default=None,
                   help="when set, /stop and /reload require this key")
    p.add_argument("--batching", action=argparse.BooleanOptionalAction, default=None,
                   help="coalesce concurrent queries into one device dispatch")
    p.add_argument("--batch-policy", choices=("adaptive", "fixed"), default=None)
    p.add_argument("--batch-max", type=int, default=None)
    p.add_argument("--batch-wait-ms", type=float, default=None,
                   help="adaptive: wait cap; fixed: the constant window")
    p.add_argument("--cache", action=argparse.BooleanOptionalAction, default=None,
                   help="LRU+TTL result cache over canonical query JSON, "
                        "invalidated on /reload")
    p.add_argument("--cache-max-entries", type=int, default=None)
    p.add_argument("--cache-ttl-s", type=float, default=None)
    p.add_argument("--shm-cache", action=argparse.BooleanOptionalAction, default=None,
                   dest="shm_cache",
                   help="back the result cache with ONE shared-memory segment every "
                        "--workers sibling attaches (implies --cache; a platform "
                        "without shared memory keeps private caches)")
    p.add_argument("--shm-slots", type=int, default=None, dest="shm_slots",
                   help="slots of the shared cache table (PIO_SERVING_SHM_SLOTS)")
    p.add_argument("--shm-slot-bytes", type=int, default=None, dest="shm_slot_bytes",
                   help="bytes a shared-cache slot (PIO_SERVING_SHM_SLOT_BYTES)")
    p.add_argument("--request-deadline-ms", type=float, default=None,
                   help="per-query time budget (0: none); a blown budget answers 503")
    p.add_argument("--retrieval", choices=("brute", "ann"), default=None,
                   help="'ann' probes the IVF index saved beside the model (built at "
                        "deploy when missing) and rescores the shortlist exactly; "
                        "'brute' scores the whole item table per query")
    p.add_argument("--ann-nlist", type=int, default=None, dest="ann_nlist",
                   help="IVF cell count of a deploy-time build (0: auto ~4*sqrt(catalog))")
    p.add_argument("--ann-nprobe", type=int, default=None, dest="ann_nprobe",
                   help="cells probed per query (0: auto nlist/64, floored at 16)")
    p.add_argument("--ann-rescore", type=int, default=None, dest="ann_rescore",
                   help="cap on the candidates rescored per query (0: all probed)")
    p.add_argument("--online", action=argparse.BooleanOptionalAction, default=None,
                   help="fold new events into the deployed ALS model between retrains")
    p.add_argument("--online-interval-s", type=float, default=None,
                   dest="online_interval_s",
                   help="tail polling interval (the freshness lag floor; default 1.0)")
    p.add_argument("--online-overlay-max", type=int, default=None,
                   dest="online_overlay_max",
                   help="max folded users held in the serving overlay (LRU)")
    p.add_argument("--online-state-dir", default=None, dest="online_state_dir",
                   help="directory of the durable tail cursor (default: in memory)")
    p.add_argument("--tracing", action=argparse.BooleanOptionalAction, default=None,
                   help="per-request spans for /queries.json, served on "
                        "GET /traces.json (absent: PIO_TRACE)")
    p.add_argument("--access-log", action=argparse.BooleanOptionalAction, default=None,
                   dest="access_log",
                   help="structured JSON access logs (absent: PIO_ACCESS_LOG)")

    p = sub.add_parser(
        "router",
        help="launch the fleet router fronting N engine-server replicas "
             "(docs/fleet.md)",
    )
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--backend", action="append", metavar="HOST:PORT",
                   help="stable replica address (repeatable; required)")
    p.add_argument("--canary-backend", action="append", metavar="HOST:PORT",
                   dest="canary_backend",
                   help="canary replica address (repeatable)")
    p.add_argument("--canary-weight", type=float, default=None,
                   dest="canary_weight", metavar="PCT",
                   help="initial %% of traffic routed to the canary group")
    # None falls through to RouterConfig's PIO_ROUTER_* env-aware
    # defaults (the ServerConfig discipline — no re-hard-coding here)
    p.add_argument("--probe-interval-s", type=float, default=None,
                   dest="probe_interval_s")
    p.add_argument("--probe-timeout-s", type=float, default=None,
                   dest="probe_timeout_s",
                   help="per-probe socket bound; size for the replica's "
                        "p99 under load, NOT idle latency — a saturated "
                        "CPython replica can sit >1s on /healthz "
                        "(docs/fleet.md runbooks)")
    p.add_argument("--down-after", type=int, default=None, dest="down_after",
                   help="consecutive failed probes before mark-down")
    p.add_argument("--up-after", type=int, default=None, dest="up_after",
                   help="consecutive good probes before mark-up")
    p.add_argument("--max-inflight", type=int, default=None,
                   dest="max_inflight",
                   help="bounded admission: concurrent in-flight requests")
    p.add_argument("--request-deadline-ms", type=float, default=None,
                   dest="request_deadline_ms")
    p.add_argument("--hedge", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="tail-latency hedging: fire a second attempt on "
                        "another replica after a p99-derived delay")
    p.add_argument("--router-key", default=None, dest="router_key",
                   help="when set, /fleet/canary and /stop require this key")
    p.add_argument("--workers", type=int, default=1,
                   help="router worker processes sharing the listen "
                        "port via SO_REUSEPORT (one CPython process "
                        "tops out on its GIL long before the fleet "
                        "does); each worker probes and holds canary "
                        "state independently — see docs/fleet.md")
    p.add_argument("--engine", action="append", metavar="SPEC",
                   help="a named engine group behind this router "
                        "(repeatable; docs/fleet.md \"Multi-engine "
                        "routing\"): comma-separated key=value pairs — "
                        "name=rec,backend=h:p+h:p[,canary=h:p]"
                        "[,weight=10][,qps=100][,burst=200]"
                        "[,max-inflight=64][,replicas=2,port-base=8300]"
                        "[,min-replicas=1,max-replicas=4][,credits=50]"
                        " (replicas= spawns supervised engine replicas "
                        "from --replica-cmd; min/max-replicas= bound "
                        "that engine's OWN scale controller under the "
                        "shared --replica-budget; credits= caps its "
                        "burst-credit reservoir). Requests route by path "
                        "/engines/<name>/queries.json or the "
                        "X-PIO-Engine header; bare /queries.json keeps "
                        "hitting the default engine")
    p.add_argument("--default-engine", default=None, dest="default_engine",
                   metavar="NAME",
                   help="engine bare /queries.json routes to (default: "
                        "the --backend group, else the first --engine; "
                        "PIO_ROUTER_DEFAULT_ENGINE)")
    p.add_argument("--access-log", action=argparse.BooleanOptionalAction,
                   default=None, dest="access_log",
                   help="structured JSON access logs")
    p.add_argument("--tracing", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="root span per routed query (admission, pick, "
                        "attempt/retry/hedge) with trace context "
                        "forwarded to replicas for cross-process "
                        "stitching; see `pio trace`")
    # self-healing (docs/fleet.md "Supervision" / "Autoscaling"):
    # PIO_FLEET_* env tunes the supervisor backoff/crash-loop and the
    # scale policy defaults; None here falls through to those
    p.add_argument("--supervise", action="store_true",
                   help="own the worker siblings (and --replica-cmd "
                        "replicas): respawn on death with damped "
                        "backoff, latch crash loops, drain the whole "
                        "fleet on SIGTERM")
    p.add_argument("--replica-cmd", default=None, dest="replica_cmd",
                   metavar="CMD",
                   help="shell-style command template spawning one "
                        "engine-server replica; {port} is substituted "
                        "(e.g. 'pio deploy --port {port}'); requires "
                        "--supervise")
    p.add_argument("--replica-key", default=None, dest="replica_key",
                   help="accessKey the supervisor sends on POST /drain "
                        "when the --replica-cmd replicas run with a "
                        "server key (PIO_FLEET_DRAIN_KEY)")
    p.add_argument("--replica-port-base", type=int, default=8200,
                   dest="replica_port_base",
                   help="first replica port for --replica-cmd spawns "
                        "(sequential from here, scale-ups included)")
    p.add_argument("--replicas", type=int, default=None,
                   help="initial --replica-cmd replica count (default: "
                        "max(1, --min-replicas))")
    p.add_argument("--min-replicas", type=int, default=None,
                   dest="min_replicas",
                   help="scale controller floor (PIO_FLEET_MIN_REPLICAS)")
    p.add_argument("--max-replicas", type=int, default=None,
                   dest="max_replicas",
                   help="scale controller ceiling (PIO_FLEET_MAX_REPLICAS)")
    p.add_argument("--scale-dry-run", action="store_true",
                   dest="scale_dry_run",
                   help="evaluate the scale policy but only EXPORT "
                        "verdicts (pio_fleet_desired_replicas vs "
                        "actual + decision counters) — the rollout "
                        "posture; see docs/fleet.md")
    p.add_argument("--scale-interval-s", type=float, default=None,
                   dest="scale_interval_s")
    p.add_argument("--scale-pressure-up", type=float, default=None,
                   dest="scale_pressure_up",
                   help="scale up when pio_fleet_pressure sustains "
                        "at/above this (PIO_FLEET_PRESSURE_UP)")
    p.add_argument("--scale-burn-up", type=float, default=None,
                   dest="scale_burn_up",
                   help="scale up when the fast-window SLO burn rate "
                        "reaches this (PIO_FLEET_BURN_UP)")
    p.add_argument("--scale-up-sustain-s", type=float, default=None,
                   dest="scale_up_sustain_s")
    p.add_argument("--scale-down-sustain-s", type=float, default=None,
                   dest="scale_down_sustain_s",
                   help="quiet cooldown before a scale-in "
                        "(PIO_FLEET_DOWN_SUSTAIN_S)")
    p.add_argument("--scale-cooldown-s", type=float, default=None,
                   dest="scale_cooldown_s",
                   help="minimum gap between scale actions "
                        "(PIO_FLEET_COOLDOWN_S)")
    p.add_argument("--replica-budget", type=int, default=None,
                   dest="replica_budget",
                   help="fleet-wide replica budget across ALL engines "
                        "(device/HBM slots; 0 = unlimited, "
                        "PIO_FLEET_REPLICA_BUDGET). Contention is "
                        "burn-weighted; a hot tenant may preempt an "
                        "idle tenant's above-min replica "
                        "(docs/fleet.md \"Per-tenant elasticity\")")

    p = sub.add_parser(
        "trace",
        help="fetch and render one stitched fleet trace from the "
             "router (docs/observability.md)",
    )
    p.add_argument("trace_id", help="the X-PIO-Trace-Id of the request")
    p.add_argument("--router", default="127.0.0.1:8100",
                   metavar="HOST:PORT",
                   help="router address serving /traces.json (default "
                        "127.0.0.1:8100)")
    p.add_argument("--chrome", action="store_true",
                   help="emit Chrome trace-viewer JSON instead of the "
                        "text tree (open in chrome://tracing or "
                        "ui.perfetto.dev)")
    p.add_argument("--out", default=None,
                   help="write --chrome JSON to this file")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="HTTP timeout for the router fetch")

    p = sub.add_parser(
        "lint",
        help="AST invariant checker for the serving/compute paths "
             "(docs/static-analysis.md)",
    )
    p.add_argument(
        "paths", nargs="*",
        help="files or directories (default: the installed predictionio_tpu_torch package)",
    )
    p.add_argument(
        "--rule", action="append", dest="rules", metavar="RULE_ID",
        help="run only this rule (repeatable; see --list-rules)",
    )
    p.add_argument("--list-rules", action="store_true",
                   help="list registered rules and exit")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text",
                   help="json includes run stats (files, cache hits, "
                        "phase timings); sarif emits SARIF 2.1.0")
    p.add_argument("--baseline", metavar="FILE",
                   help="report (and fail on) only findings NOT in this "
                        "baseline snapshot — lets a stricter rule land "
                        "before the tree is fully clean")
    p.add_argument("--write-baseline", metavar="FILE",
                   dest="write_baseline",
                   help="snapshot the current findings to FILE and exit 0")
    p.add_argument("--changed", action="store_true",
                   help="report only findings in files git sees as "
                        "modified/untracked (the whole tree is still "
                        "analyzed, so cross-module passes stay sound)")
    p.add_argument("--no-project", action="store_true", dest="no_project",
                   help="skip whole-program passes (shared-state-race, "
                        "lock-order, jit-recompile-risk)")
    p.add_argument("--no-cache", action="store_true", dest="no_cache",
                   help="neither read nor write the per-file result cache")

    p = sub.add_parser("undeploy", help="stop a deployed engine server")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--server-key", default=None)
    parser.subparsers = sub  # handle for late-bound subcommand registration
    return parser


#: commands that build no Storage: the router, `pio trace` and `pio
#: status --router` talk HTTP only, `wal` works on the journal
#: directory (its replay builds the storage itself), and `lint` reads
#: source files
STORAGE_FREE_COMMANDS = frozenset({"version", "lint", "wal", "router", "trace"})

#: commands that run the training or serving pipeline and therefore join
#: the multi-process group when PIO_NUM_HOSTS > 1
COMPUTE_COMMANDS = frozenset({"train", "eval", "deploy", "run"})

_COMMANDS = {
    "version": _cmd_version,
    "status": _cmd_status,
    "app": _cmd_app,
    "accesskey": _cmd_accesskey,
    "eventserver": _cmd_eventserver,
    "wal": _cmd_wal,
    "export": _cmd_export,
    "import": _cmd_import,
    "train": _cmd_train,
    "eval": _cmd_eval,
    "deploy": _cmd_deploy,
    "undeploy": _cmd_undeploy,
    "router": _cmd_router,
    "trace": _cmd_trace,
    "lint": _cmd_lint,
}

_EXTRA_PARSERS: list = []


def register_command(name: str, configure_parser, run) -> None:
    """Extension point: a module adds a subcommand (``pio experiment``
    registers itself from ``experiment/cli.py`` on import)."""
    _COMMANDS[name] = run
    _EXTRA_PARSERS.append((name, configure_parser))


register_command("dashboard", _configure_dashboard, _cmd_dashboard)
register_command("adminserver", _configure_adminserver, _cmd_adminserver)
register_command("build", _configure_build, _cmd_build)
register_command("run", _configure_run, _cmd_run)
register_command("upgrade", _configure_upgrade, _cmd_upgrade)
register_command("template", _configure_template, _cmd_template)


def main(argv: list[str] | None = None) -> int:
    # late-bound subcommands register on import
    import predictionio_tpu_torch.experiment.cli  # noqa: F401

    parser = build_parser()
    for name, configure in _EXTRA_PARSERS:
        configure(parser.subparsers)
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 1
    if args.command in COMPUTE_COMMANDS:
        # multi-process: join the torch.distributed group when
        # PIO_NUM_HOSTS > 1; admin commands never wait on the other ranks
        from predictionio_tpu_torch.parallel.distributed import maybe_initialize_distributed

        maybe_initialize_distributed()
    storage_free = args.command in STORAGE_FREE_COMMANDS or (
        args.command == "status" and args.router)
    storage = None if storage_free else Storage()
    return _COMMANDS[args.command](args, storage)


if __name__ == "__main__":
    # under ``python -m`` this file runs as ``__main__``, while
    # ``experiment/cli.py`` registers into the ``predictionio_tpu_torch.cli.pio``
    # instance: go through that one, or the late-bound commands are lost
    from predictionio_tpu_torch.cli.pio import main as _canonical_main

    sys.exit(_canonical_main())
