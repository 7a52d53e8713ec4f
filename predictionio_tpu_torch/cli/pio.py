"""`pio`: the command line over one store (port of the JAX package's
``cli/pio.py`` and ``workflow/cli_commands.py``, for the commands this
port serves).

    python -m predictionio_tpu_torch.cli.pio <command> ...

- ``version``; ``status`` (verifies every storage repository);
- ``app new|list|show|delete|data-delete|channel-new|channel-delete``
  (a new app gets an access key) and ``accesskey new|list|delete``
  (``new --event E`` whitelists event names);
- ``import`` / ``export``: events as JSON lines;
- ``eventserver``: the event server (``api/event_server.py``) in this
  process, with ``--stats`` and the write-ahead journal flags
  ``--wal-dir``, ``--wal-fsync``, ``--wal-max-bytes``, ``--wal-policy``
  (an absent flag leaves the ``PIO_EVENTSERVER_WAL_*`` default);
  ``wal status|replay|dead-letter``: operate that journal;
- ``train``: ``workflow/train.run_train`` of an engine.json variant,
  recording an engine instance;
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
  ``PIO_ONLINE_*`` default), and the feedback loop ``--feedback
  --event-server-ip --event-server-port --accesskey``; ``undeploy``:
  POST /stop to a running one.

``train``, ``eval`` and ``deploy`` run on the card unless ``--device
cpu`` is given; the other commands, ``eventserver`` among them, do not
import torch. Storage is configured as the JAX package configures it (the
``PIO_STORAGE_*`` variables; with none set, sqlite + localfs under
``$PIO_FS_BASEDIR``), so both packages can work on one store. Arguments,
messages and exit codes are the JAX package's. Not ported yet:
``deploy --workers/--shm-cache`` (item 23), ``--tracing`` and ``train --profile`` (item 12), ``build``/``run``, the router, ``experiment`` and the admin
tools (item 23), and Parquet import and export (item 25).
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


def _cmd_status(args, storage: Storage) -> int:
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


def _cmd_export(args, storage: Storage) -> int:
    from predictionio_tpu_torch.tools.export_import import export_events

    ok, channel_id = _resolve_app_channel(storage, args.appid, args.channel)
    if not ok:
        return 1
    with open(args.output, "w") as f:
        n = export_events(storage, args.appid, f, channel_id)
    print(f"[INFO] Exported {n} events to {args.output}")
    return 0


def _cmd_import(args, storage: Storage) -> int:
    from predictionio_tpu_torch.tools.export_import import ImportFormatError, import_events

    ok, channel_id = _resolve_app_channel(storage, args.appid, args.channel)
    if not ok:
        return 1
    if not os.path.exists(args.input):
        print(f"[ERROR] {args.input} not found.")
        return 1
    try:
        with open(args.input) as f:
            n = import_events(storage, args.appid, f, channel_id)
    except ImportFormatError as e:
        print(f"[ERROR] {args.input}: {e}")
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
        ip=args.ip, port=args.port, stats=args.stats, **wal_overrides)).start()
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
    outcome = run_train(variant=variant, workflow_params=wp, storage=storage,
                        ctx=EngineContext(wp, storage, device=args.device))
    print(f"[INFO] Training finished: engine instance {outcome.instance_id} "
          f"({outcome.status})")
    if outcome.stage_seconds:
        print(f"[INFO] Stage times: {format_stage_times(outcome.stage_seconds)}")
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


def _cmd_deploy(args, storage: Storage) -> int:
    from predictionio_tpu_torch.api.engine_server import create_engine_server
    from predictionio_tpu_torch.api.http_base import serve_until_stopped
    from predictionio_tpu_torch.workflow.deploy import ServerConfig
    from predictionio_tpu_torch.workflow.engine_json import read_variant

    try:
        variant = read_variant(args.engine_json)
    except json.JSONDecodeError as exc:
        print(f"[ERROR] {args.engine_json} is not valid JSON: {exc}")
        return 1
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
        # an absent flag leaves ServerConfig's PIO_SERVING_* default
        **{k: v for k, v in {
            "batching": args.batching,
            "batch_policy": args.batch_policy,
            "batch_max": args.batch_max,
            "batch_wait_ms": args.batch_wait_ms,
            "cache_enabled": args.cache,
            "cache_max_entries": args.cache_max_entries,
            "cache_ttl_s": args.cache_ttl_s,
            "request_deadline_ms": args.request_deadline_ms,
            "retrieval": args.retrieval,
            "ann_nlist": args.ann_nlist,
            "ann_nprobe": args.ann_nprobe,
            "ann_rescore": args.ann_rescore,
            "online": args.online,
            "online_interval_s": args.online_interval_s,
            "online_overlay_max": args.online_overlay_max,
            "online_state_dir": args.online_state_dir,
        }.items() if v is not None},
    )
    server = create_engine_server(storage=storage, config=config).start()
    print(f"[INFO] Engine instance {server.deployed.instance_id} listening on "
          f"{args.ip}:{server.port}", flush=True)
    serve_until_stopped(server)
    return 0


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
    sub.add_parser("status", help="verify environment and storage")

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

    p = sub.add_parser("export", help="export an app's events to a JSON-lines file")
    p.add_argument("--appid", type=int, required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--channel", default=None)
    p = sub.add_parser("import", help="import events from a JSON-lines file")
    p.add_argument("--appid", type=int, required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--channel", default=None)

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

    p = sub.add_parser("undeploy", help="stop a deployed engine server")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--server-key", default=None)
    return parser


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
}


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 1
    # `wal` works on the journal directory alone; its replay builds the
    # storage itself
    storage = None if args.command in ("version", "wal") else Storage()
    return _COMMANDS[args.command](args, storage)


if __name__ == "__main__":
    sys.exit(main())
