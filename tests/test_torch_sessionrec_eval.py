"""The port's sessionrec evaluation on the CPU, against the JAX package's
template: the same leave-one-out folds of the same events, the same
HitRate@K of the same triples, the same (query, prediction, actual)
triples from ``Engine.eval`` when each fold's model is the JAX-trained
one carried across, and a port-trained run of JAX's own
``test_hit_rate_eval`` (tests/test_sessionrec_template.py).
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.controller import EngineParams as JaxEngineParams
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.templates import sessionrec as jsess
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.context import EngineContext as JaxEngineContext
from predictionio_tpu_torch.controller import EngineParams, EngineParamsGenerator
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.base import App
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import sessionrec
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.evaluation import run_evaluation

N_USERS = 48
CYCLE = 10  # items walk i0 -> i1 -> ... -> i9 -> i0
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
#: scores of the same f32 model on both sides: f32 sums in another order
SCORE_TOL = 1e-4


def _events(lengths=None):
    """tests/test_sessionrec_template.py's walk (every user steps through
    the item cycle from a random start), with per-user lengths: by
    default 8 each, as there; fixed ids so both stores break time ties
    alike."""
    rng = np.random.default_rng(0)
    lengths = lengths or [8] * N_USERS
    out = []
    for u, n in enumerate(lengths):
        start = int(rng.integers(CYCLE))
        out += [dict(event="view", entity_type="user", entity_id=f"u{u}",
                     target_entity_type="item", target_entity_id=f"i{(start + t) % CYCLE}",
                     event_time=T0 + timedelta(minutes=u * 100 + t), event_id=f"e{u:03d}{t:02d}")
                for t in range(n)]
    return out


def _stores(events):
    def fill(storage, app_cls, event_cls):
        app_id = storage.get_meta_data_apps().insert(app_cls(0, "SessApp"))
        storage.get_events().init(app_id)
        storage.get_events().insert_batch([event_cls(**e) for e in events], app_id)
        return storage
    return fill(memory_storage(), App, Event), fill(jax_memory_storage(), JaxApp, JaxEvent)


def _ctx(storage):
    return EngineContext(storage=storage, device="cpu")


def _folds(folds):
    return [(td.sequences, ei, [(dataclasses.asdict(q), a) for q, a in qa])
            for td, ei, qa in folds]


class TestReadEval:
    @pytest.mark.parametrize("eval_k", [0, 1, 2, 3])
    @pytest.mark.parametrize("min_len", [2, 3, 5])
    def test_folds_equal_jax(self, eval_k, min_len):
        """Users of 1-6 items: below, at and above ``min_sequence_len``
        (a user at it trains but is never held out)."""
        port, jax_storage = _stores(_events([1 + u % 6 for u in range(N_USERS)]))
        params = dict(app_name="SessApp", eval_k=eval_k, min_sequence_len=min_len)
        got = sessionrec.SessionDataSource(sessionrec.DataSourceParams(**params)).read_eval(
            _ctx(port))
        want = jsess.SessionDataSource(jsess.DataSourceParams(**params)).read_eval(
            JaxEngineContext(storage=jax_storage))
        assert _folds(got) == _folds(want)
        assert len(got) == max(eval_k, 1)
        held = [q.user for _, _, qa in got for q, _ in qa]
        assert len(held) == len(set(held))              # each user held out once at most
        full = sessionrec.SessionDataSource(sessionrec.DataSourceParams(
            app_name="SessApp", min_sequence_len=min_len)).read_training(_ctx(port)).sequences
        assert {u for u, s in full.items() if len(s) > min_len} == set(held)
        for td, _, qa in got:
            for q, a in qa:
                assert td.sequences[q.user] + [a] == full[q.user]


class TestHitRate:
    @pytest.mark.parametrize("k", [1, 3, 10])
    def test_hit_rate_equals_jax(self, k):
        rng = np.random.default_rng(k)
        items = [f"i{j}" for j in range(12)]
        triples = []
        for j in range(40):
            top = [items[int(x)] for x in rng.permutation(12)[: int(rng.integers(0, 12))]]
            p = sessionrec.PredictedResult(tuple(sessionrec.ItemScore(i, 1.0 / (n + 1))
                                                 for n, i in enumerate(top)))
            jp = jsess.PredictedResult(tuple(jsess.ItemScore(s.item, s.score)
                                             for s in p.item_scores))
            triples.append((sessionrec.Query(user=f"u{j}"), p, jsess.Query(user=f"u{j}"), jp,
                            items[int(rng.integers(12))]))
        port, jax_metric = sessionrec.HitRateAtK(k), jsess.HitRateAtK(k)
        assert port.header == jax_metric.header == f"HitRate@{k}"
        for q, p, jq, jp, a in triples:
            assert port.calculate_qpa(q, p, a) == jax_metric.calculate_qpa(jq, jp, a)
        got = port.calculate([({"fold": 0}, [(q, p, a) for q, p, _, _, a in triples])])
        want = jax_metric.calculate([({"fold": 0}, [(q, p, a) for _, _, q, p, a in triples])])
        assert got == want
        # an empty prediction is a miss, never left out of the mean
        assert port.calculate_qpa(triples[0][0], sessionrec.PredictedResult(), "i1") == 0.0


ALGO = dict(d_model=32, n_heads=2, n_layers=1, max_len=16, epochs=15, batch_size=16, lr=3e-3)


class TestEngineEvalVsJax:
    def test_jax_fold_models_give_the_same_triples(self, monkeypatch):
        """JAX's Engine.eval trains each fold (in f32); the port's
        Engine.eval serves the same folds with those models carried
        across by ``SeqRecEngineModel.from_jax``: the same queries and
        answers, the served items equal where their scores are not tied,
        scores within SCORE_TOL, and the same HitRate@3."""
        port, jax_storage = _stores(_events())
        jax_models = []
        real = jsess.SeqRecAlgorithm.train

        def train_f32(self, ctx, pd):
            m = real(self, ctx, pd)
            m = dataclasses.replace(m, cfg=dataclasses.replace(m.cfg, dtype=jnp.float32),
                                    device_tree=None)
            jax_models.append(m)
            return m

        monkeypatch.setattr(jsess.SeqRecAlgorithm, "train", train_f32)
        jep = JaxEngineParams.of(data_source=jsess.DataSourceParams(app_name="SessApp", eval_k=2),
                                 algorithms=[("seqrec", jsess.AlgorithmParams(**ALGO,
                                                                              use_mesh=False))])
        want = jsess.engine_factory().eval(JaxEngineContext(storage=jax_storage), jep)

        carried = iter(jax_models)
        monkeypatch.setattr(sessionrec.SeqRecAlgorithm, "train", lambda self, ctx, pd: (
            sessionrec.SeqRecEngineModel.from_jax(
                m.params, dataclasses.asdict(m.cfg), m.item_index.to_dict(), m.histories,
                device="cpu") if (m := next(carried)) else None))
        ep = EngineParams.of(data_source=sessionrec.DataSourceParams(app_name="SessApp", eval_k=2),
                             algorithms=[("seqrec", sessionrec.AlgorithmParams(**ALGO))])
        got = sessionrec.engine_factory().eval(_ctx(port), ep)

        assert len(got) == len(want) == 2 and len(jax_models) == 2
        for (gei, g), (wei, w) in zip(got, want):
            assert gei == wei and len(g) == len(w) > 0
            for (gq, gp, ga), (wq, wp, wa) in zip(g, w):
                assert dataclasses.asdict(gq) == dataclasses.asdict(wq) and ga == wa
                gs = [(s.item, s.score) for s in gp.item_scores]
                ws = [(s.item, s.score) for s in wp.item_scores]
                assert len(gs) == len(ws)
                np.testing.assert_allclose([s for _, s in gs], [s for _, s in ws],
                                           atol=SCORE_TOL)
                for n, ((gi, _), (wi, s)) in enumerate(zip(gs, ws)):
                    near = [x for _, x in ws[max(n - 1, 0):n] + ws[n + 1:n + 2]]
                    if all(abs(s - x) > SCORE_TOL for x in near):
                        assert gi == wi
        metric, jax_metric = sessionrec.HitRateAtK(3), jsess.HitRateAtK(3)
        assert metric.calculate(got) == jax_metric.calculate(want)


class TestHitRateEval:
    def test_port_trained_hit_rate_eval(self, tmp_path):
        """JAX's test_hit_rate_eval through the port: the deterministic
        item cycle makes the next item easy, so HitRate@3 is far above
        the 3/10 random baseline."""
        port, _ = _stores(_events())
        generator = EngineParamsGenerator([EngineParams.of(
            data_source=sessionrec.DataSourceParams(app_name="SessApp", eval_k=2),
            algorithms=[("seqrec", sessionrec.AlgorithmParams(**ALGO))])])
        outcome = run_evaluation(
            sessionrec.SessionRecEvaluation(k=3, output_path=str(tmp_path / "best.json")),
            generator, storage=port, ctx=_ctx(port))
        assert (tmp_path / "best.json").exists()
        assert outcome.status == "EVALCOMPLETED"
        assert outcome.result.best_score.score > 0.5
        assert "HitRate@3" in outcome.result.metric_header

    def test_default_params_list_equals_jax(self):
        got = sessionrec.DefaultParamsList(app_name="A", eval_k=3).engine_params_list
        want = jsess.DefaultParamsList(app_name="A", eval_k=3).engine_params_list
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert dataclasses.asdict(g.data_source_params[1]) == \
                dataclasses.asdict(w.data_source_params[1])
            assert [(n, dataclasses.asdict(p)) for n, p in g.algorithm_params_list] == \
                [(n, dataclasses.asdict(p)) for n, p in w.algorithm_params_list]
        evaluation = sessionrec.SessionRecEvaluation(k=5, output_path=None)
        assert evaluation.evaluator.metric.header == "HitRate@5"
        assert evaluation.evaluator.output_path is None
