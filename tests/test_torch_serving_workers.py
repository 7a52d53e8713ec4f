"""The port's prefork serving pool on the CPU, held against the JAX
package's on the same inputs:

- ``serving/workers.WorkerCoherence`` and ``fleet/workers.WorkerHub``:
  the same publish / adopt / sync sequences (hypothesis) give the same
  states, sequence numbers and apply callbacks; the hub finds, fetches
  and reaps peers as JAX's does;
- ``obs/aggregate``: ``merge_sources`` renders Prometheus text
  byte-identical to JAX's for the same sources (hypothesis labels,
  hostile label values included), and parsing inverts rendering;
- ``serving/placement``: the CPU stripes equal JAX's (hypothesis);
- ``utils/checkpoint``'s mmap half: a mapped load equals an eager one
  (and JAX's), the ALS model loads aliased to the mapping, and the mapped
  file's bytes are unchanged after queries and an online fold;
- ``fleet/supervisor``: the same respawn, crash-loop and stop schedule as
  JAX's on a manual clock;
- two in-process engine servers on one spool (as JAX's
  ``TestWorkerPoolScrape`` and ``TestAdminCoherence`` run them) beside two
  JAX servers on another: a sessionrec model JAX trained, carried across
  by ``SeqRecEngineModel.from_jax``, answers equally; ``/metrics``,
  ``/stats.json`` and ``/traces.json`` fold the pool; drain, retrieval
  and reload reach the sibling; a late joiner adopts the state;
- the kernels are built once, by the deploy process, before any worker
  starts (a stand-in ``nvcc``), and no spawned worker builds.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import socket
import stat
import subprocess
import sys
import tempfile
import time
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from predictionio_tpu.api import engine_server as jserver_mod
from predictionio_tpu.controller import FirstServing as JaxFirstServing
from predictionio_tpu.fleet import supervisor as jsup
from predictionio_tpu.fleet import workers as jworkers
from predictionio_tpu.obs import aggregate as jagg
from predictionio_tpu.obs.exporter import render_metrics as jrender
from predictionio_tpu.obs.histogram import HistogramSnapshot as JaxSnapshot
from predictionio_tpu.obs.registry import Metric as JaxMetric
from predictionio_tpu.serving import placement as jplacement
from predictionio_tpu.serving import workers as jcoherence
from predictionio_tpu.storage.base import EngineInstance as JaxEngineInstance
from predictionio_tpu.templates import sessionrec as jsess
from predictionio_tpu.utils import checkpoint as jckpt
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.deploy import DeployedEngine as JaxDeployedEngine
from predictionio_tpu.workflow.deploy import ServerConfig as JaxServerConfig
from predictionio_tpu_torch.api import engine_server as pserver_mod
from predictionio_tpu_torch.cli import pio
from predictionio_tpu_torch.controller import PersistentModelManifest
from predictionio_tpu_torch.fleet import supervisor as psup
from predictionio_tpu_torch.fleet import workers as pworkers
from predictionio_tpu_torch.models import als as pals
from predictionio_tpu_torch.obs import aggregate as pagg
from predictionio_tpu_torch.obs import compile as pcompile
from predictionio_tpu_torch.obs.exporter import render_metrics as prender
from predictionio_tpu_torch.obs.histogram import HistogramSnapshot
from predictionio_tpu_torch.obs.registry import Metric
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.serving import placement as pplacement
from predictionio_tpu_torch.serving import workers as pcoherence
from predictionio_tpu_torch.storage.base import EngineInstance
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import sessionrec as psess
from predictionio_tpu_torch.utils import checkpoint as pckpt
from predictionio_tpu_torch.utils import resilience as pres
from predictionio_tpu_torch.workflow.deploy import ServerConfig
from predictionio_tpu_torch.workflow.persistence import save_models

REPO = Path(__file__).resolve().parent.parent
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
SCORE_TOL = 1e-5
SESS = ("predictionio_tpu_torch.templates.sessionrec.engine_factory", "seqrec",
        "predictionio_tpu_torch.templates.sessionrec.SeqRecAlgorithm")


def _wait(pred, timeout: float = 15.0, what: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- coherence and the hub against JAX ----------------------------------------

PKGS = {"port": (pworkers, pcoherence), "jax": (jworkers, jcoherence)}

ops = st.lists(st.one_of(
    st.tuples(st.just("publish"), st.integers(0, 2), st.sampled_from(
        [{"reloadSeq": 1}, {"reloadSeq": 2}, {"draining": True}, {"draining": False},
         {"retrieval": {"retrieval": "ann", "annNprobe": 8}}, {"retrieval": None},
         {"reloadSeq": 3, "draining": True}])),
    st.tuples(st.just("sync"), st.integers(0, 2), st.none()),
    st.tuples(st.just("next"), st.integers(0, 2), st.none()),
    st.tuples(st.just("adopt"), st.integers(0, 2), st.none())), max_size=12)


@pytest.fixture(scope="module")
def hubs():
    """Three hubs of each package over one spool each, shared by the
    examples (a hub's loopback server takes ~0.5 s to stop)."""
    out = {}
    for pkg, (hub_mod, _) in PKGS.items():
        spool = tempfile.mkdtemp(prefix=f"pio-coherence-{pkg}-")
        out[pkg] = [hub_mod.WorkerHub(spool, metrics_text=lambda: "",
                                      traces_snapshot=lambda: []) for _ in range(3)]
    yield out
    for group in out.values():
        for hub in group:
            hub.close()


def _run_coherence(pkg: str, steps, hubs: list) -> list:
    """Three workers' coherence over one spool (its admin document
    removed first); the observable trace of ``steps``: each call's
    result, each worker's state, every apply callback's (new, prev), and
    the document's sequence."""
    co_mod = PKGS[pkg][1]
    try:
        os.unlink(os.path.join(hubs[0].spool_dir, "admin.state"))
    except FileNotFoundError:
        pass
    trace: list = []
    workers = [co_mod.WorkerCoherence(
        hub, lambda new, prev, i=i: trace.append(("apply", i, new, prev)))
        for i, hub in enumerate(hubs)]
    for op, i, arg in steps:
        w = workers[i]
        if op == "publish":
            trace.append(("publish", i, w.publish(**arg)))
        elif op == "sync":
            trace.append(("sync", i, w.sync_once()))
        elif op == "next":
            trace.append(("next", i, w.next_reload_seq()))
        else:
            trace.append(("adopt", i, w.adopt()))
        doc = hubs[0].read_admin()
        trace.append(("doc", doc["seq"] if doc else None, [x.state() for x in workers]))
    return trace


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(steps=ops)
def test_coherence_sequences_equal_jax(hubs, steps):
    assert _run_coherence("port", steps, hubs["port"]) == \
        _run_coherence("jax", steps, hubs["jax"])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_hub_peers_fetch_and_reap(pkg, tmp_path):
    """Both hubs: a sibling's exposition, traces and extra documents are
    fetched over its loopback endpoint; a dead worker's entry is reaped;
    the admin document is sequenced; the last one out removes the spool."""
    hub_mod = PKGS[pkg][0]
    spool = str(tmp_path / "spool")
    a = hub_mod.WorkerHub(spool, metrics_text=lambda: "a_total 1\n",
                          traces_snapshot=lambda: [{"traceId": "ta"}],
                          extra_paths={"/stats.json": lambda: {"requestCount": 3}})
    b = hub_mod.WorkerHub(spool, metrics_text=lambda: "b_total 2\n",
                          traces_snapshot=lambda: [{"traceId": "tb"}],
                          extra_paths={"/stats.json": lambda: {"requestCount": 4}})
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True).stdout.strip()
    with open(os.path.join(spool, f"{dead}-1.json"), "w") as f:
        json.dump({"worker": f"{dead}-1", "pid": int(dead), "port": 1}, f)
    try:
        got = {
            "peers": [p["worker"] for p in a.peers()],
            "metrics": a.fetch_peer_bodies("/metrics"),
            "traces": [json.loads(body) for _, body in a.fetch_peer_bodies("/traces.json")],
            "stats": [json.loads(body) for _, body in b.fetch_peer_bodies("/stats.json")],
            "missing": b.fetch_peer_bodies("/nope"),
            "seqs": [a.publish_admin({"action": "x"}), b.publish_admin({"action": "y"})],
            "admin": {k: v for k, v in b.read_admin().items() if k != "publishedBy"},
        }
        assert got["peers"] == [b.worker_id]
        assert got["metrics"] == [(b.worker_id, b"b_total 2\n")]
        assert got["traces"] == [{"traces": [{"traceId": "tb"}]}]
        assert got["stats"] == [{"requestCount": 3}]
        assert got["missing"] == []
        assert got["seqs"] == [1, 2]
        assert got["admin"] == {"action": "y", "seq": 2}
        assert not os.path.exists(os.path.join(spool, f"{dead}-1.json"))
    finally:
        a.close()
        b.close()
    assert not os.path.exists(spool)


# -- aggregation against JAX ---------------------------------------------------

label_values = st.text(alphabet=st.sampled_from(list('ab"\\\n{}= ,x')), max_size=6)
label_sets = st.dictionaries(st.sampled_from(["route", "kind", "le_", "q"]), label_values,
                             max_size=2)
BOUNDS = (0.001, 0.01, 0.1, 1.0, float("inf"))


@st.composite
def sources(draw):
    out = []
    for w in range(draw(st.integers(1, 3))):
        fams = []
        for name, kind in (("pio_x_total", "counter"), ("pio_g", "gauge"),
                           ("pio_h_seconds", "histogram")):
            samples, hists = [], []
            for labels in draw(st.lists(label_sets, max_size=3, unique_by=lambda d: tuple(
                    sorted(d.items())))):
                if kind == "histogram":
                    counts = draw(st.lists(st.integers(0, 5), min_size=4, max_size=4))
                    cum = np.cumsum(counts + [draw(st.integers(0, 3))]).tolist()
                    hists.append((labels, (BOUNDS, tuple(int(c) for c in cum),
                                           float(draw(st.integers(0, 100))) / 8, int(cum[-1]))))
                else:
                    samples.append((labels, float(draw(st.integers(0, 1000))) / 4))
            fams.append((name, kind, samples, hists))
        out.append((f"{1000 + w}-1", fams))
    return out


def _families(pkg: str, families):
    metric, snap = (Metric, HistogramSnapshot) if pkg == "port" else (JaxMetric, JaxSnapshot)
    return [metric(name=name, kind=kind, help=f"help of {name}", samples=list(samples),
                   histograms=[(labels, snap(bounds=b, cumulative=c, sum=s, count=n))
                               for labels, (b, c, s, n) in hists])
            for name, kind, samples, hists in families]


@settings(max_examples=60, deadline=None)
@given(srcs=sources())
def test_merge_sources_renders_byte_identical_to_jax(srcs):
    got = prender(pagg.merge_sources([(w, _families("port", f)) for w, f in srcs])
                  + [pagg.source_count_metric("pio_serving_workers", "h", len(srcs))])
    want = jrender(jagg.merge_sources([(w, _families("jax", f)) for w, f in srcs])
                   + [jagg.source_count_metric("pio_serving_workers", "h", len(srcs))])
    assert got == want
    # parsing inverts rendering (label values holding "}" included, which
    # the JAX package's parser refuses): the parsed text renders back
    assert prender(pagg.parse_exposition(got)) == got


def test_parse_exposition_rejects_what_jax_rejects():
    for text in ("pio_x 1\n", "# TYPE h histogram\nh_bucket{le=\"1\"} 1\n",
                 "# TYPE c counter\nc 1.2e\n", "# TYPE c summary\n"):
        with pytest.raises(jagg.ExpositionParseError):
            jagg.parse_exposition(text)
        with pytest.raises(pagg.ExpositionParseError):
            pagg.parse_exposition(text)


# -- placement against JAX ------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(index=st.integers(-1, 9), total=st.integers(0, 9),
       cpus=st.sets(st.integers(0, 63), max_size=20))
def test_placement_stripes_equal_jax(index, total, cpus):
    assert pplacement.assign_worker_cpus(index, total, cpus) == \
        jplacement.assign_worker_cpus(index, total, cpus)


def test_apply_affinity_pins_to_the_stripe_of_the_snapshot():
    allowed = tuple(sorted(os.sched_getaffinity(0)))
    if len(allowed) < 2:
        pytest.skip("needs two CPUs")
    code = ("import os, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from predictionio_tpu_torch.serving.placement import apply_worker_affinity\n"
            f"print(sorted(apply_worker_affinity(1, 2, cpus={allowed!r})),"
            " sorted(os.sched_getaffinity(0)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60).stdout
    stripe = sorted(jplacement.assign_worker_cpus(1, 2, allowed))
    assert out.strip() == f"{stripe} {stripe}"


# -- the mmap half of utils/checkpoint ------------------------------------------

def _als_dir(tmp_path, users=30, items=1100, rank=6):
    """An ALS model saved by the port (factors and, past 1,024 items, the
    ANN index), with a store holding an app and rating events."""
    rng = np.random.default_rng(0)
    U = rng.standard_normal((users, rank)).astype(np.float32)
    I = rng.standard_normal((items, rank)).astype(np.float32)
    seen = {u: np.sort(rng.choice(items, 5, replace=False)).astype(np.int32)
            for u in range(users)}
    model = pals.ALSModel.from_jax(U, I, {f"u{i}": i for i in range(users)},
                                   {f"i{i}": i for i in range(items)}, seen, device="cpu")
    directory = str(tmp_path / "als")
    model.save(directory)
    return directory, U, I


def _digest(directory: str) -> str:
    h = hashlib.sha256()
    for root, _, files in sorted(os.walk(directory)):
        for name in sorted(files):
            if name.endswith(".npz"):
                with open(os.path.join(root, name), "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


def test_mmap_round_trip_equals_eager_and_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jckpt, "_ocp", lambda: None)
    arrays = {"user": np.arange(24, dtype=np.float32).reshape(6, 4),
              "item": np.full((3, 4), 2.5, dtype=np.float32),
              "ids": np.arange(7, dtype=np.int32)}
    directory = str(tmp_path / "ckpt")
    pckpt.save_sharded(directory, arrays)
    eager = pckpt.load_sharded(directory)
    mapped = pckpt.load_sharded(directory, mmap_mode="r")
    jmapped = jckpt.load_sharded(directory, mmap_mode="r")
    for name, want in arrays.items():
        assert isinstance(mapped[name], np.memmap) and not mapped[name].flags.writeable
        np.testing.assert_array_equal(mapped[name], want)
        np.testing.assert_array_equal(eager[name], want)
        np.testing.assert_array_equal(jmapped[name], want)
    monkeypatch.setenv("PIO_CHECKPOINT_MMAP", "r")
    assert pckpt.default_mmap_mode() == jckpt.default_mmap_mode() == "r"
    assert isinstance(pckpt.load_sharded(directory)["user"], np.memmap)
    # a header that disagrees with the manifest is refused, mapped or not
    meta_path = os.path.join(directory, "checkpoint_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["arrays"]["user"]["shape"] = [4, 6]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(pckpt.CheckpointCorruptError):
        pckpt.load_sharded(directory, mmap_mode="r")


def test_unmappable_payload_falls_back_to_the_verified_load(tmp_path, caplog):
    directory = str(tmp_path / "ckpt")
    os.makedirs(directory)
    np.savez_compressed(os.path.join(directory, "arrays.npz"), user=np.ones((2, 2)))
    out = pckpt.load_sharded(directory, mmap_mode="r")
    assert not isinstance(out["user"], np.memmap)
    assert any("falling back" in r.getMessage() for r in caplog.records)


def test_mapped_als_model_aliases_the_file_and_never_writes_it(tmp_path, monkeypatch):
    """Under PIO_CHECKPOINT_MMAP=r the CPU model's tables ARE the
    read-only mapping (one host copy for the pool); queries, ANN queries
    and an online fold read it and leave the file's bytes unchanged."""
    from predictionio_tpu_torch.online.overlay import OnlineOverlay, UserDelta

    directory, U, I = _als_dir(tmp_path)
    before = _digest(directory)
    eager = pals.ALSModel.load(directory, device="cpu")
    monkeypatch.setenv("PIO_CHECKPOINT_MMAP", "r")
    mapped = pals.ALSModel.load(directory, device="cpu")
    # the tables' memory lies inside mappings of the checkpoint payloads
    def mapped_ranges(directory: str) -> list:
        with open(os.path.join(directory, "checkpoint_meta.json")) as f:
            payload = os.path.realpath(os.path.join(directory, json.load(f)["payload"]))
        with open("/proc/self/maps") as f:
            return [tuple(int(x, 16) for x in line.split()[0].split("-")) for line in f
                    if line.rstrip().endswith(payload)]

    ranges = mapped_ranges(directory)
    for addr in (mapped.user_factors.data_ptr(), mapped.item_factors.data_ptr()):
        assert any(lo <= addr < hi for lo, hi in ranges)
    ann_ranges = mapped_ranges(os.path.join(directory, "ann"))
    flat = mapped.ann_index.flat_vecs
    assert not flat.flags.writeable
    assert any(lo <= flat.ctypes.data < hi for lo, hi in ann_ranges)
    np.testing.assert_array_equal(mapped.item_factors.numpy(), I)
    for user in ("u0", "u7", "nobody"):
        assert mapped.recommend(user, 10) == eager.recommend(user, 10)
    mapped.configure_retrieval("ann", nprobe=mapped.ann_index.nlist)
    eager.configure_retrieval("ann", nprobe=eager.ann_index.nlist)
    assert mapped.recommend("u3", 10) == eager.recommend("u3", 10)
    overlay = OnlineOverlay()
    mapped.set_online_overlay(overlay)
    overlay.put_user("u1", UserDelta(vector=np.ones(6, dtype=np.float32), extra_seen=(0,),
                                     delta_seen=(), folded_events=1, event_time_us=0),
                     generation=0)
    assert mapped.recommend("u1", 5)
    assert _digest(directory) == before


# -- the supervisor against JAX ------------------------------------------------------

class _Handle:
    """A process handle whose death the test decides."""

    def __init__(self, log, name):
        self.log, self.name, self.code = log, name, None
        self.pid = 1000 + len(log)
        log.append(("spawn", name))

    def poll(self):
        return self.code

    def terminate(self):
        self.log.append(("terminate", self.name))
        self.code = -15

    def kill(self):
        self.code = -9

    def wait(self, timeout=None):
        return self.code


def _supervise(pkg: str) -> list:
    sup_mod, res_mod = (psup, pres) if pkg == "port" else (jsup, jres)
    import random

    clock = res_mod.ManualClock()
    log: list = []
    handles: dict = {}

    def spawner(name):
        def spawn():
            handles[name] = _Handle(log, name)
            return handles[name]
        return spawn

    cfg = sup_mod.SupervisorConfig(crash_loop_threshold=3, crash_loop_window_s=10.0,
                                   backoff_base_s=0.5, backoff_max_s=4.0)
    sup = sup_mod.FleetSupervisor(
        [sup_mod.SpawnSpec(id=f"worker:{i}", spawn=spawner(f"w{i}"), role=sup_mod.WORKER)
         for i in (1, 2)], config=cfg, clock=clock, rng=random.Random(7))
    sup.start(loop=False)
    out = []
    for step in range(12):
        if step in (1, 3, 5):
            handles["w1"].code = 1          # w1 keeps dying: crash loop
        if step == 2:
            handles["w2"].code = -9         # w2 dies once: respawned
        sup.poll_once()
        clock.advance(1.0)
        out.append(sorted((c["id"], c["state"], c["respawns"], c["deaths"])
                          for c in sup.children()))
    metrics = [(m.name, m.kind, sorted((tuple(sorted(l.items())), v) for l, v in m.samples))
               for m in sup_mod.supervisor_collector(sup)()]
    sup.shutdown()
    return out + [log, metrics, sup.child_events("worker:1"), sup.child_events("worker:2")]


def test_supervisor_schedule_equals_jax():
    assert _supervise("port") == _supervise("jax")


# -- two in-process servers on one spool, beside JAX's --------------------------------

@pytest.fixture(scope="module")
def sessionrec_models():
    """(JAX algorithm, its f32 model, the port's model of the same arrays)."""
    rng = np.random.default_rng(0)
    sequences = {f"u{u}": [f"i{(int(rng.integers(12)) + t) % 12}" for t in range(9)]
                 for u in range(24)}
    algo = jsess.SeqRecAlgorithm(jsess.AlgorithmParams(
        d_model=32, n_heads=2, n_layers=2, max_len=16, epochs=2, batch_size=16, lr=3e-3,
        seed=0, use_mesh=False))
    jmodel = algo.train(None, jsess.TrainingData(sequences=sequences))
    jmodel32 = dataclasses.replace(
        jmodel, cfg=dataclasses.replace(jmodel.cfg, dtype=jnp.float32), device_tree=None)
    port = psess.SeqRecEngineModel.from_jax(
        jmodel32.params, dataclasses.asdict(jmodel32.cfg), jmodel32.item_index.to_dict(),
        jmodel32.histories, device="cpu")
    return algo, jmodel32, port


def _store(storage, location, start=T0) -> str:
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=start, completion_time=start, engine_id="e",
        engine_version="1", engine_variant="e", engine_factory=SESS[0],
        algorithms_params=json.dumps([{"name": SESS[1], "params": {}}])))
    save_models(storage, iid, [PersistentModelManifest(SESS[2], location)])
    return iid


def _pool_config(cls, port, spool, **extra):
    return cls(ip="127.0.0.1", port=port, reuse_port=True, worker_spool_dir=spool,
               admin_sync_interval_s=0.1, cache_enabled=True, cache_ttl_s=300.0,
               batching=True, batch_wait_ms=1.0, tracing=True, **extra)


@pytest.fixture
def pools(sessionrec_models, tmp_path):
    """(port servers, port pool's port, JAX servers, JAX pool's port)."""
    algo, jmodel, pmodel = sessionrec_models
    storage = memory_storage()
    location = str(tmp_path / "model")
    psess.save_engine_model(pmodel, location)
    iid = _store(storage, location)
    pport, jport = _free_port(), _free_port()
    pspool, jspool = str(tmp_path / "pspool"), str(tmp_path / "jspool")
    port_servers = [pserver_mod.create_engine_server(storage, _pool_config(
        ServerConfig, pport, pspool, device="cpu", engine_instance_id=iid)).start()
        for _ in range(2)]
    jax_servers = []
    for _ in range(2):
        deployed = JaxDeployedEngine(
            jsess.engine_factory(), JaxEngineInstance(
                id="jax-instance", status="COMPLETED", start_time=T0, completion_time=T0,
                engine_id="e", engine_version="1", engine_variant="e", engine_factory="jax"),
            [algo], JaxFirstServing(), [jmodel])
        server = jserver_mod.EngineServer(deployed, _pool_config(JaxServerConfig, jport, jspool),
                                          storage=jax_memory_storage())
        server.start()
        jax_servers.append(server)
    yield port_servers, pport, jax_servers, jport, storage, tmp_path
    for server in port_servers + jax_servers:
        server.stop()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def _counters(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("pio_serving_") and not line.startswith("#") and "{" not in line:
            name, value = line.split()
            out[name] = float(value)
    return out


def test_pool_answers_and_folded_scrapes_equal_jax(pools):
    port_servers, pport, jax_servers, jport, _, _ = pools
    queries = ([{"user": f"u{u}", "num": 3 + u % 4} for u in range(12)]
               + [{"items": ["i1", "i2", "i3"], "num": 4}, {"user": "nobody", "num": 2}])
    for q in queries:                        # a fresh connection each: both workers answer
        got, want = _post(pport, q), _post(jport, q)
        assert [s["item"] for s in got["itemScores"]] == [s["item"] for s in want["itemScores"]]
        np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                                   [s["score"] for s in want["itemScores"]], atol=SCORE_TOL)
    pstats, jstats = (json.loads(_get(p, "/stats.json")) for p in (pport, jport))
    assert pstats["workers"]["count"] == jstats["workers"]["count"] == 2
    assert pstats["workers"]["requestCount"] == jstats["workers"]["requestCount"] == len(queries)
    assert set(pstats["workers"]) == set(jstats["workers"]) | {"admin"}
    assert sum(s.deployed.request_count for s in port_servers) == len(queries)
    # the folded counters are the pool's totals, wherever the scrape lands
    pm, jm = (_counters(_get(p, "/metrics").decode()) for p in (pport, jport))
    for name in ("pio_serving_batched_queries_total", "pio_serving_cache_misses_total"):
        assert pm[name] == jm[name] == len(queries)
    assert pm["pio_serving_workers"] == jm["pio_serving_workers"] == 2
    own = [_counters(s.service.worker_hub._metrics_text()) for s in port_servers]
    assert sum(o["pio_serving_batched_queries_total"] for o in own) == len(queries)
    traces = json.loads(_get(pport, "/traces.json"))["traces"]
    assert len(traces) == len(queries)
    assert len({t.get("source", "local") for t in traces}) == 2


def test_admin_state_reaches_the_sibling_as_in_jax(pools):
    port_servers, _, jax_servers, _, storage, tmp_path = pools
    seen = {}
    for name, (w1, w2) in (("port", port_servers), ("jax", jax_servers)):
        steps = []
        assert w1.service.handle("POST", "/drain", {}, {}, None)[0] == 200
        _wait(lambda: w2.service.readyz()[0] == 503, what=f"{name} sibling drained")
        steps.append((w1.service.readyz()[1]["status"], w2.service.readyz()[1]["status"]))
        w2.service.handle("POST", "/drain", {}, {}, {"action": "undrain"})
        _wait(lambda: w1.service.readyz()[0] == 200, what=f"{name} sibling undrained")
        status = w2.service.handle("POST", "/retrieval", {}, {},
                                   {"retrieval": "brute", "annNprobe": 32})[0]
        _wait(lambda: w1.service.config.ann_nprobe == 32, what=f"{name} retrieval")
        steps.append((status, w1.service.coherence.state(), w2.service.coherence.state()))
        assert w1.service.handle("POST", "/retrieval", {}, {}, {"retrieval": "nope"})[0] == 400
        steps.append(w1.service.worker_hub.read_admin()["seq"])
        seen[name] = steps
    assert seen["port"] == seen["jax"]
    # /reload on one worker: the sibling swaps too, onto the same generation
    w1, w2 = port_servers
    location = str(tmp_path / "model2")
    psess.save_engine_model(w1.deployed.models[0], location)
    new_iid = _store(storage, location, start=datetime(2026, 2, 1, tzinfo=timezone.utc))
    assert w1.service.handle("GET", "/reload", {}, {}, None)[0] == 200
    _wait(lambda: w2.deployed.instance_id == new_iid, what="sibling reload")
    # one generation for both caches (the retrieval change above moved
    # each once already; a reload never moves one backwards)
    assert w1.service.cache.generation == w2.service.cache.generation == 2
    assert w1.service.model_generation == w2.service.model_generation == 1
    admin = json.loads(_get(w1.port, "/stats.json"))["workers"]["admin"]
    assert sorted(a["modelGeneration"] for a in admin.values()) == [1, 1]
    # a late joiner (a respawn) adopts the current state without reloading
    w1.service.handle("POST", "/drain", {}, {}, None)
    w3 = pserver_mod.create_engine_server(storage, dataclasses.replace(
        w1.config, engine_instance_id=None, engine_id="e")).start()
    try:
        assert w3.service.readyz()[1]["status"] == "draining"
        assert w3.service.model_generation == 1
        assert w3.service.cache.generation == w1.service.cache.generation
    finally:
        w3.stop()
    # a swallowed publish failure answers 500, as in JAX
    w2.service.coherence.publish = lambda **kw: w2.service.coherence.state()
    status, payload = w2.service.handle("POST", "/drain", {}, {}, {"action": "undrain"})[:2]
    assert status == 500 and "publishing to the worker pool failed" in payload["message"]


def test_access_log_lines_carry_the_worker(pools, caplog, monkeypatch):
    import logging

    monkeypatch.setattr(logging.getLogger("pio.access"), "propagate", True)
    port_servers, pport, _, _, _, _ = pools
    for server in port_servers:
        server.service.access_log = True
    with caplog.at_level(logging.INFO, logger="pio.access"):
        for u in range(6):
            _post(pport, {"user": f"u{u}", "num": 2})
    workers = {json.loads(r.getMessage()).get("worker") for r in caplog.records
               if r.name == "pio.access"}
    assert workers and workers <= {s.service.worker_id for s in port_servers}


# -- the kernels: built once, before any worker starts ------------------------------

def test_the_pool_builds_each_kernel_once_and_no_worker_builds(tmp_path, monkeypatch):
    """`pio deploy --workers N` on the card builds before it spawns: one
    nvcc a kernel in the deploy process, recorded as one compile; the
    spawned workers find the libraries built and run no nvcc."""
    log = tmp_path / "nvcc.log"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho run >> "{log}"\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info: fake" && : > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pcompile, "_GLOBAL_RECORDER", pcompile.CompileRecorder())
    # the deploy process's step, as _deploy_pool runs it on the card
    assert set(_build.build_all()) == set(_build.kernel_names())
    assert pcompile.stats_doc()["compiles"] == len(_build.kernel_names())
    runs = log.read_text().count("run")
    # N workers from the pool's start method, each checking the build
    ctx = multiprocessing.get_context(pio.POOL_START_METHOD)
    children = [ctx.Process(target=_child_build, args=(str(tmp_path / "build"),))
                for _ in range(2)]
    for child in children:
        child.start()
    for child in children:
        child.join(60)
    assert [c.exitcode for c in children] == [0, 0]
    assert log.read_text().count("run") == runs == len(_build.kernel_names())


def _child_build(build_dir: str) -> None:
    """A spawned worker's view of the build (exit 1 if it builds)."""
    from pathlib import Path as _P

    from predictionio_tpu_torch.obs import compile as c
    from predictionio_tpu_torch.ops import _build as b

    b.BUILD_DIR = _P(build_dir)
    built = b.build_all()
    sys.exit(1 if built or c.stats_doc()["compiles"] else 0)
