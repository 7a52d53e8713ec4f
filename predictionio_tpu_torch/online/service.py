"""The online fold-in service: tail → solve → publish, on a loop (port of
the JAX package's ``online/service.py``).

One :class:`OnlineFoldIn` runs inside an engine server deployed with
``pio deploy --online``. Per cycle, paced by ``Event.wait`` on the
configured interval:

1. **tail**: read everything past the durable ``(eventTime, id)`` cursor
   (:mod:`~predictionio_tpu_torch.online.follower`);
2. **solve**: give brand-new items a popularity-prior or symmetric-solve
   vector, then recompute every touched user's vector with the
   closed-form rank x rank solve over their full interaction set
   (:mod:`~predictionio_tpu_torch.online.foldin`: idempotent, so the
   at-least-once cursor commit is safe). The factor rows a solve needs
   are gathered on the factor table's device and copied to the host in
   f32; the solve is host NumPy, on this background thread;
3. **publish**: install the deltas into the serving overlay
   (generation-fenced: a fold computed against model generation G is
   discarded once ``/reload`` lands G+1), invalidate exactly the touched
   users' result-cache entries, and commit the cursor.

With tracing on (the engine server's ``tracing``), each cycle that
folds records an ``online.foldin`` trace with ``tail``, ``solve`` and
``publish`` spans into the server's trace ring.

Across a worker pool (``pio deploy --workers N --online``): ONE worker
holds the tail lease (an ``O_EXCL`` claim file in the pool's spool,
reaped when its pid is gone, like the worker entries) and folds; after
each cycle that changed the overlay it publishes the whole overlay as a
sequenced ``online.state`` document (the ``serving/workers.py``
discipline: cumulative, committed with an atomic ``os.replace``). The
siblings load that snapshot into their own overlay, fenced by the model
generation like a local fold, and invalidate the result-cache entries of
the users whose vectors changed. Each worker scores the overlay against
its OWN device copy of the factor tables. A dead leader's lease is taken
by whichever sibling's next cycle notices, and the new leader resumes
from the published cursor.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from predictionio_tpu_torch.online.follower import (
    CursorStore,
    EventTailFollower,
    TailCursor,
    TailRow,
)
from predictionio_tpu_torch.online.foldin import (
    item_gramian,
    popularity_prior,
    solve_item,
    solve_user,
)
from predictionio_tpu_torch.online.overlay import ItemDelta, OnlineOverlay, UserDelta
from predictionio_tpu_torch.storage.base import EventFilter

logger = logging.getLogger(__name__)

#: the leader's published overlay snapshot in the pool's spool
ONLINE_STATE_FILE = "online.state"
#: the tail-lease claim file (one folding leader per pool)
ONLINE_LEASE_FILE = "online.lease"


def user_key_fragment(user_id: str) -> str:
    """The canonical-JSON fragment a recommendation-family query for
    ``user_id`` carries in its result-cache key, derived through
    ``canonical_json`` itself so the spelling cannot drift from the
    cache's keys."""
    from predictionio_tpu_torch.core.json_codec import canonical_json

    return canonical_json({"user": user_id})[1:-1]


@dataclasses.dataclass
class OnlineBinding:
    """What the fold-in needs, resolved from a deployment: the event
    stream's coordinates, the rating rule, and the ALS model and the
    hyperparameters the closed-form solve must mirror."""

    events: Any
    app_id: int
    channel_id: int | None
    entity_type: str
    target_entity_type: str
    event_names: tuple[str, ...] | None
    buy_rating: float | None
    model: Any                      # ALSModel (the fold-in target)
    lam: float
    implicit: bool
    alpha: float

    def rating_of(self, event: str, props: Mapping[str, Any]) -> float | None:
        """The template family's rating rule: ``rate`` events carry their
        rating property (malformed → dropped); anything else is worth
        ``buy_rating`` when the template defines one, else 1.0."""
        if event == "rate":
            try:
                return float(props["rating"])
            except (KeyError, TypeError, ValueError):
                return None
        if self.buy_rating is not None:
            return float(self.buy_rating)
        return 1.0

    def tail_filter(self) -> EventFilter:
        return EventFilter(
            entity_type=self.entity_type,
            event_names=(list(self.event_names)
                         if self.event_names else None),
        )


def resolve_online_binding(deployed: Any, storage: Any) -> OnlineBinding | None:
    """The fold-in binding of a deployed engine, or None when the
    deployment has no ALS-family model or no resolvable app (the service
    then stays inert with a warning: ``--online`` on a classification
    engine must not kill the deploy)."""
    from predictionio_tpu_torch.workflow.deploy import retrieval_targets

    instance = getattr(deployed, "instance", None)
    if instance is None or storage is None:
        logger.warning("online fold-in: the deployment has no engine instance or store")
        return None
    try:
        params = deployed.engine.params_from_instance_json(
            instance.data_source_params, instance.preparator_params,
            instance.algorithms_params, instance.serving_params)
    except Exception:
        logger.warning("online fold-in: engine params unresolvable", exc_info=True)
        return None
    ds = params.data_source_params[1]
    app_name = getattr(ds, "app_name", "")
    if not app_name:
        logger.warning("online fold-in: data source names no app")
        return None
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        logger.warning("online fold-in: app %r not found", app_name)
        return None
    model = algo_params = algo = None
    for (_, ap), a, m in zip(params.algorithm_params_list, deployed.algorithms,
                             deployed.models):
        targets = list(retrieval_targets([m]))
        if targets:
            model, algo_params, algo = targets[0], ap, a
            break
    if model is None:
        logger.warning("online fold-in: no ALS-family model in this deployment")
        return None
    implicit = bool(getattr(algo_params, "implicit_prefs",
                            getattr(algo, "implicit_prefs", False)))
    return OnlineBinding(
        events=storage.get_events(),
        app_id=app.id,
        channel_id=None,
        entity_type=getattr(ds, "entity_type", "user"),
        target_entity_type=getattr(ds, "target_entity_type", "item"),
        event_names=(tuple(getattr(ds, "event_names", ()) or ()) or None),
        buy_rating=getattr(ds, "buy_rating", None),
        model=model,
        lam=float(getattr(algo_params, "lambda_", 0.01)),
        implicit=implicit,
        alpha=float(getattr(algo_params, "alpha", 1.0)),
    )


class TailLease:
    """One folding leader per worker pool: an ``O_EXCL`` claim file in
    the spool directory, naming the worker and its pid; a dead holder's
    claim is reaped."""

    def __init__(self, spool_dir: str, owner: str):
        self.path = os.path.join(spool_dir, ONLINE_LEASE_FILE)
        self.owner = owner

    def _holder(self) -> dict | None:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else None
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None

    def try_hold(self) -> bool:
        """True when this worker holds (or just claimed) the lease."""
        holder = self._holder()
        if holder is not None:
            if holder.get("worker") == self.owner:
                return True
            try:
                os.kill(int(holder.get("pid", -1)), 0)
                return False            # a live leader elsewhere
            except (ProcessLookupError, ValueError):
                try:
                    os.unlink(self.path)   # a dead leader: reap
                except OSError:
                    return False
            except PermissionError:
                return False            # alive, another uid
        try:
            fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_EXCL)
        except OSError:                 # lost the claim race, or worse
            return False
        with os.fdopen(fd, "w") as f:
            json.dump({"worker": self.owner, "pid": os.getpid()}, f)
        logger.info("online tail lease claimed by %s", self.owner)
        return True

    def release(self) -> None:
        holder = self._holder()
        if holder is not None and holder.get("worker") == self.owner:
            try:
                os.unlink(self.path)
            except OSError:
                pass


def _host_table(factors: torch.Tensor) -> np.ndarray:
    """A whole factor table on the host in f32 (once per generation)."""
    return factors.detach().to(torch.float32).cpu().numpy()


class OnlineFoldIn:
    """The per-server fold-in loop (module docstring)."""

    def __init__(
        self,
        *,
        storage: Any,
        deployed_fn: Callable[[], Any],
        generation_fn: Callable[[], int],
        interval_s: float = 1.0,
        overlay_max: int = 4096,
        state_dir: str | None = None,
        invalidate_user: Callable[[str], None] | None = None,
        worker_hub: Any = None,
        initial_cursor: TailCursor | None = None,
        trace_log: Any = None,
        tracing: bool = False,
    ):
        self.storage = storage
        self._deployed_fn = deployed_fn
        self._generation_fn = generation_fn
        self.interval_s = max(0.05, float(interval_s))
        self._invalidate_user = invalidate_user
        #: the engine server's trace ring (obs/trace.TraceLog); one
        #: online.foldin trace per folding cycle when tracing is on
        self._trace_log = trace_log
        self._tracing = tracing
        self._hub = worker_hub
        self._state_dir = state_dir
        self._initial_cursor = initial_cursor
        self.overlay = OnlineOverlay(
            max_users=overlay_max,
            max_items=max(64, overlay_max // 4),
            generation=generation_fn())
        self.enabled = False
        self._binding: OnlineBinding | None = None
        self._follower: EventTailFollower | None = None
        #: the pool half (module docstring): the lease, whether this
        #: worker leads, the last snapshot sequence it applied or
        #: published, and the (mtime_ns, size) of the last snapshot it
        #: processed (an unchanged stat skips the parse)
        self._lease: TailLease | None = None
        self._is_leader = False
        self._adopted_leader_state = False
        self._applied_seq = 0
        self._doc_stamp: tuple | None = None
        #: users to re-solve against a freshly reloaded model (the
        #: overlay cleared at the generation fence)
        self._pending_refold: set[str] = set()
        #: per-generation solve constants (implicit gramian, item prior):
        #: one full-table host read per model generation
        self._gram: tuple[int, np.ndarray] | None = None
        self._prior: tuple[int, np.ndarray] | None = None
        self._lock = threading.Lock()
        self._stats = {
            "foldedEvents": 0, "foldCycles": 0, "usersFolded": 0,
            "itemsAdded": 0, "errors": 0, "lagSeconds": None,
        }
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._rebind()
        if self._binding is None:
            logger.warning(
                "--online requested but this deployment cannot fold in (no ALS model / "
                "unresolvable app); the freshness plane stays inert")
            return
        cursor_path = (os.path.join(self._state_dir, "online.cursor")
                       if self._state_dir else None)
        if cursor_path:
            os.makedirs(self._state_dir, exist_ok=True)
        self._follower = EventTailFollower(
            self._binding.events, self._binding.app_id, self._binding.channel_id,
            self._binding.tail_filter(), store=CursorStore(cursor_path))
        if self._follower.cursor is None:
            # tail from now: history up to deploy time is the trained
            # model's; back-dated events wait for the next retrain
            self._follower.cursor = (self._initial_cursor
                                     or TailCursor(int(time.time() * 1_000_000), ""))
        if self._hub is not None:
            self._lease = TailLease(self._hub.spool_dir, self._hub.worker_id)
        self.enabled = True
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="pio-online-foldin",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            was_leader = self._is_leader
        if self._lease is not None and was_leader:
            self._lease.release()

    def _run(self) -> None:
        # Event.wait paces the loop and stops it promptly
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001: a failed cycle is the next one's problem
                with self._lock:
                    self._stats["errors"] += 1
                logger.exception("online fold-in cycle failed")

    # -- model-swap hook (EngineService.reload) -----------------------------
    def on_model_swapped(self, generation: int) -> None:
        """A ``/reload`` landed: fence the overlay (deltas computed
        against the old model are discarded), rebind to the new model,
        and queue every folded user for a refold against it."""
        # under _lock: the fold thread swaps this set out concurrently
        with self._lock:
            self._pending_refold |= set(self.overlay.touched_users())
        self.overlay.advance_generation(generation)
        # both caches key on the generation captured at cycle start, so a
        # cycle that refills them after this clear heals at its next check
        self._gram = None
        self._prior = None
        self._rebind()
        if self._follower is not None and self._binding is not None:
            self._follower.events = self._binding.events

    def _rebind(self) -> None:
        self._binding = resolve_online_binding(self._deployed_fn(), self.storage)
        if self._binding is not None:
            self._install_overlay()

    def _install_overlay(self) -> None:
        from predictionio_tpu_torch.workflow.deploy import retrieval_targets

        for target in retrieval_targets(getattr(self._deployed_fn(), "models", ())):
            if hasattr(target, "set_online_overlay"):
                target.set_online_overlay(self.overlay)

    # -- one cycle ---------------------------------------------------------
    def tick(self) -> int:
        """One loop pass: fold when this process is the only or the
        lease-holding tailer, else apply the leader's published
        snapshot. Returns the events folded, or the users applied."""
        if not self.enabled:
            return 0
        if self._lease is None or self._lease.try_hold():
            if self._lease is not None and not self._adopted_leader_state:
                self._adopt_leader_state()
            with self._lock:
                self._is_leader = True
            return self._fold_once()
        with self._lock:
            self._is_leader = False
        self._adopted_leader_state = False
        return self._sync_once()

    def _adopt_leader_state(self) -> None:
        """A newly promoted leader resumes from the PUBLISHED cursor (the
        previous leader's progress), not its own stale one."""
        doc = self._read_pool_doc()
        if doc is not None:
            cursor = TailCursor.from_doc(doc.get("cursor"))
            if cursor is not None:
                self._follower.commit(cursor)
            with self._lock:
                self._applied_seq = int(doc.get("seq", 0))
        self._adopted_leader_state = True

    def _fold_once(self) -> int:
        # generation first, then the binding: a /reload completing during
        # the tail poll leaves `generation` stale, which the overlay's
        # fence rejects at publish
        generation = self._generation_fn()
        binding = self._binding
        trace = None
        if self._tracing and self._trace_log is not None:
            from predictionio_tpu_torch.obs.trace import start_trace

            trace = start_trace("online.foldin", service="engine")
        t0 = time.perf_counter()
        rows, new_cursor = self._follower.poll_once()
        t_tail = time.perf_counter()
        with self._lock:
            refold, self._pending_refold = self._pending_refold, set()
        if not rows and not refold:
            return 0
        try:
            return self._solve_and_publish(binding, generation, rows, new_cursor, refold,
                                           trace, t0, t_tail)
        except Exception:
            # the cursor was not committed, so the rows replay; the refold
            # queue was swapped out and its users' events are behind the
            # cursor: restore it
            with self._lock:
                self._pending_refold |= refold
            raise

    def _solve_and_publish(self, binding: OnlineBinding, generation: int,
                           rows: list[TailRow], new_cursor: TailCursor | None,
                           refold: set[str], trace: Any = None, t0: float = 0.0,
                           t_tail: float = 0.0) -> int:
        by_user: dict[str, list[TailRow]] = {}
        by_item: dict[str, list[TailRow]] = {}
        for row in rows:
            if row.target_entity_id is None:
                continue
            by_user.setdefault(row.entity_id, []).append(row)
            by_item.setdefault(row.target_entity_id, []).append(row)
        model = binding.model
        new_items = {
            iid: ItemDelta(vector=self._solve_new_item(binding, evs, generation))
            for iid, evs in by_item.items()
            if model.item_ids.get(iid) is None
        }
        deltas: dict[str, UserDelta] = {}
        for uid in set(by_user) | refold:
            delta = self._fold_user(binding, uid, by_user.get(uid, ()), new_items,
                                    generation)
            if delta is not None:
                deltas[uid] = delta
        t_solve = time.perf_counter()
        applied = 0
        fenced = False
        for iid, delta in new_items.items():
            if not self.overlay.put_item(iid, delta, generation=generation):
                fenced = True
        for uid, delta in deltas.items():
            if self.overlay.put_user(uid, delta, generation=generation):
                applied += 1
                if self._invalidate_user is not None:
                    self._invalidate_user(uid)
            else:
                fenced = True
        if fenced:
            # a /reload raced this cycle: keep the cursor, so the next
            # cycle re-reads these events against the new model
            with self._lock:
                self._pending_refold |= set(deltas)
        else:
            self._follower.commit(new_cursor)
        lag = (time.time() - min(r.time_us for r in rows) / 1e6) if rows else None
        publish = self._hub is not None and not fenced and bool(applied or new_items)
        with self._lock:
            self._stats["foldCycles"] += 1
            if not fenced:
                # a fenced cycle applied nothing and will re-read its rows
                self._stats["foldedEvents"] += len(rows)
                self._stats["usersFolded"] += applied
                self._stats["itemsAdded"] += len(new_items)
                if lag is not None:
                    self._stats["lagSeconds"] = lag
        if publish:
            self._publish_pool_doc(generation, new_cursor, sorted(deltas))
        if trace is not None:
            trace.add_span("tail", t0, t_tail)
            trace.add_span("solve", t_tail, t_solve)
            trace.add_span("publish", t_solve, time.perf_counter())
            trace.finish(events=len(rows), users=applied, items=len(new_items),
                         generation=generation)
            self._trace_log.record(trace)
        return len(rows)

    # -- solves ------------------------------------------------------------
    def _item_prior(self, model: Any, gen: int) -> np.ndarray:
        # keyed on the generation captured at cycle start: a /reload
        # mid-cycle must not cache the old model's centroid as the new's
        if self._prior is None or self._prior[0] != gen:
            self._prior = (gen, popularity_prior(_host_table(model.item_factors)))
        return self._prior[1]

    def _gramian(self, factors: torch.Tensor, gen: int) -> np.ndarray:
        if self._gram is None or self._gram[0] != gen:
            self._gram = (gen, item_gramian(_host_table(factors)))
        return self._gram[1]

    def _gather_rows(self, factors: torch.Tensor, ixs: list[int]) -> np.ndarray:
        """The rows ``ixs`` of a factor table: an ``index_select`` on the
        table's device and a copy of those rows alone to the host, in
        f32."""
        index = torch.as_tensor(np.asarray(ixs, dtype=np.int64), device=factors.device)
        return factors.index_select(0, index).to(torch.float32).cpu().numpy()

    def _solve_new_item(self, binding: OnlineBinding, events: list[TailRow],
                        generation: int) -> np.ndarray:
        """A vector for an item outside the base catalog: the symmetric
        solve over its known raters when there are any, else the
        popularity prior."""
        model = binding.model
        uixs: list[int] = []
        ratings: list[float] = []
        for row in events:
            uix = model.user_ids.get(row.entity_id)
            rating = binding.rating_of(row.event, row.properties)
            if uix is not None and rating is not None:
                uixs.append(uix)
                ratings.append(rating)
        if uixs:
            vec = solve_item(
                self._gather_rows(model.user_factors, uixs),
                np.asarray(ratings, dtype=np.float32),
                lam=binding.lam, implicit=binding.implicit, alpha=binding.alpha,
                gram=(self._gramian(model.user_factors, generation)
                      if binding.implicit else None))
            if vec is not None:
                return vec
        return self._item_prior(model, generation)

    def _fold_user(self, binding: OnlineBinding, uid: str,
                   tail_rows: list[TailRow] | tuple,
                   new_items: Mapping[str, ItemDelta],
                   generation: int) -> UserDelta | None:
        """Recompute one user's vector over their full interaction set
        (read back from the event store: a recomputation, not an
        accumulation)."""
        model = binding.model
        history = binding.events.find(
            binding.app_id, binding.channel_id,
            EventFilter(entity_type=binding.entity_type, entity_id=uid,
                        event_names=(list(binding.event_names)
                                     if binding.event_names else None)))
        base_ixs: list[int] = []
        base_ratings: list[float] = []
        delta_vecs: list[np.ndarray] = []
        delta_ratings: list[float] = []
        delta_seen: list[str] = []
        for event in history:
            tid = event.target_entity_id
            if tid is None:
                continue
            rating = binding.rating_of(event.event, event.properties.fields)
            if rating is None:
                continue
            ix = model.item_ids.get(tid)
            if ix is not None:
                base_ixs.append(ix)
                base_ratings.append(rating)
                continue
            delta = new_items.get(tid) or self.overlay.item(tid)
            if delta is not None:
                delta_vecs.append(delta.vector)
                delta_ratings.append(rating)
                if tid not in delta_seen:
                    delta_seen.append(tid)
        if not base_ixs and not delta_vecs:
            return None
        parts = []
        if base_ixs:
            parts.append(self._gather_rows(model.item_factors, base_ixs))
        if delta_vecs:
            parts.append(np.stack(delta_vecs))
        vecs = np.concatenate(parts) if len(parts) > 1 else parts[0]
        ratings = np.asarray(base_ratings + delta_ratings, dtype=np.float32)
        vector = solve_user(
            vecs, ratings, lam=binding.lam, implicit=binding.implicit, alpha=binding.alpha,
            gram=(self._gramian(model.item_factors, generation)
                  if binding.implicit else None))
        if vector is None:
            return None
        times = [r.time_us for r in tail_rows]
        return UserDelta(
            vector=vector,
            extra_seen=tuple(sorted(set(base_ixs))),
            delta_seen=tuple(delta_seen),
            folded_events=len(tail_rows),
            event_time_us=max(times) if times else 0,
        )

    # -- the pool snapshot (module docstring) --------------------------------
    def _pool_doc_path(self) -> str:
        return os.path.join(self._hub.spool_dir, ONLINE_STATE_FILE)

    def _read_pool_doc(self) -> dict | None:
        try:
            with open(self._pool_doc_path()) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None
        if not isinstance(doc, dict) or not isinstance(doc.get("seq"), int):
            return None
        return doc

    def _publish_pool_doc(self, generation: int, cursor: TailCursor | None,
                          touched: list[str]) -> None:
        """The leader's cumulative overlay snapshot, sequenced and
        committed with an atomic ``os.replace``: a respawned or lagging
        sibling adopts the whole state from one read. The leader is the
        only writer and counts its own sequence (seeded from the
        document when it was promoted)."""
        users, items = self.overlay.snapshot_entries()
        with self._lock:
            seq = self._applied_seq + 1
            folded = self._stats["foldedEvents"]
            lag = self._stats["lagSeconds"]
        doc = {
            "seq": seq,
            "generation": generation,
            "cursor": cursor.to_doc() if cursor is not None else None,
            "touched": touched,
            "users": {
                uid: {"v": d.vector.tolist(),
                      "seen": [int(x) for x in d.extra_seen],
                      "deltaSeen": list(d.delta_seen),
                      "n": d.folded_events, "t": d.event_time_us}
                for uid, d in users.items()
            },
            "items": {iid: d.vector.tolist() for iid, d in items.items()},
            "foldedTotal": folded,
            "lagSeconds": lag,
            "publishedBy": self._hub.worker_id,
        }
        path = self._pool_doc_path()
        tmp = f"{path}.{self._hub.worker_id}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            with self._lock:
                self._applied_seq = seq
        except OSError:
            logger.exception("publishing online overlay snapshot failed")

    def _sync_once(self) -> int:
        """A sibling applies the leader's latest snapshot, fenced by the
        generation like a local fold (a snapshot computed against a
        model this worker has not reloaded onto yet waits, retried every
        cycle). Returns the users whose vectors changed."""
        # stat before parse: os.replace always moves mtime or size, so an
        # unchanged stat means an unchanged document
        try:
            st = os.stat(self._pool_doc_path())
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            return 0
        if stamp == self._doc_stamp:
            return 0
        doc = self._read_pool_doc()
        with self._lock:
            applied_seq = self._applied_seq
        if doc is None or doc["seq"] <= applied_seq:
            self._doc_stamp = stamp
            return 0
        generation = self._generation_fn()
        if doc.get("generation") != generation:
            return 0                    # retried until this worker catches up
        try:
            users = {
                uid: UserDelta(
                    vector=np.asarray(u["v"], dtype=np.float32),
                    extra_seen=tuple(int(x) for x in u.get("seen", ())),
                    delta_seen=tuple(u.get("deltaSeen", ())),
                    folded_events=int(u.get("n", 0)),
                    event_time_us=int(u.get("t", 0)))
                for uid, u in doc.get("users", {}).items()
            }
            items = {iid: ItemDelta(vector=np.asarray(v, dtype=np.float32))
                     for iid, v in doc.get("items", {}).items()}
        except (TypeError, ValueError):
            logger.warning("malformed online snapshot seq=%s skipped", doc.get("seq"))
            with self._lock:
                self._applied_seq = doc["seq"]
            self._doc_stamp = stamp
            return 0
        # invalidate by DIFF against this worker's overlay, not by the
        # document's `touched`: the snapshot is cumulative and this
        # sibling may have skipped publishes in between
        prior_users, _ = self.overlay.snapshot_entries()
        changed = [uid for uid, delta in users.items()
                   if (prev := prior_users.get(uid)) is None
                   or not np.array_equal(prev.vector, delta.vector)]
        if not self.overlay.load_snapshot(users, items, generation=generation):
            return 0
        self._doc_stamp = stamp
        with self._lock:
            self._applied_seq = doc["seq"]
            if doc.get("lagSeconds") is not None:
                self._stats["lagSeconds"] = doc["lagSeconds"]
        if self._invalidate_user is not None:
            for uid in changed:
                self._invalidate_user(uid)
        return len(changed)

    # -- observability ------------------------------------------------------
    def metrics(self) -> dict:
        """The fold counters and the overlay's occupancy (the JAX
        package's keys; a process outside a pool is its own leader)."""
        counters = self.overlay.counters()
        with self._lock:
            stats = dict(self._stats)
            leader = self._is_leader
            applied_seq = self._applied_seq
        return {
            "enabled": self.enabled,
            "leader": leader or self._lease is None,
            "generation": counters["generation"],
            "overlayUsers": counters["users"],
            "overlayItems": counters["items"],
            "overlaySize": counters["users"] + counters["items"],
            "evictions": counters["evictions"],
            "fenced": counters["fenced"],
            "foldedEventsTotal": stats["foldedEvents"],
            "foldCycles": stats["foldCycles"],
            "usersFoldedTotal": stats["usersFolded"],
            "itemsAddedTotal": stats["itemsAdded"],
            "errorsTotal": stats["errors"],
            "lagSeconds": stats["lagSeconds"],
            "appliedSeq": applied_seq,
        }

    def stats_doc(self) -> dict:
        """The ``/stats.json`` ``online`` section."""
        doc = self.metrics()
        doc["intervalS"] = self.interval_s
        cursor = self._follower.cursor if self._follower is not None else None
        doc["cursor"] = cursor.to_doc() if cursor is not None else None
        return doc
