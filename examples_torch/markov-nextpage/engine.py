"""Markov-chain next-page prediction — an experimental-pattern engine.

Port of the JAX package's ``examples/markov-nextpage``. Role parity: the
reference's experimental engines built on ``e2.MarkovChain`` (reference:
e2/src/main/scala/.../engine/MarkovChain.scala:33-84 — row-normalized
top-N transition model used by pattern engines under
examples/experimental/). This example turns each user's time-ordered
``view`` stream into (page -> next page) transitions, trains the port's
e2 Markov chain (``e2/engine.MarkovChain.train``: the dense transition
build and a top-k with ``lax.top_k``'s tie rule,
``markov_top_transitions``, on the context's device), and serves "what
page comes next" from the host tables it returns.

Demonstrates: a HostModelAlgorithm over an e2 library model, session
ordering from event time, and BiMap id indexing.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    FirstServing,
    HostModelAlgorithm,
    IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.e2.engine import MarkovChain, MarkovChainModel
from predictionio_tpu_torch.utils.bimap import BiMap


@dataclasses.dataclass(frozen=True)
class Query:
    page: str = ""
    num: int = 3


@dataclasses.dataclass(frozen=True)
class PageScore:
    page: str
    prob: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    pages: tuple = ()


@dataclasses.dataclass(frozen=True)
class DSParams(Params):
    app_name: str = ""
    event_name: str = "view"
    entity_type: str = "user"
    target_entity_type: str = "page"


@dataclasses.dataclass(frozen=True)
class TrainingData:
    #: (from_page, to_page) consecutive-view pairs per user stream
    transitions: tuple


class PageViewDataSource(DataSource):
    params_class = DSParams

    def read_training(self, ctx):
        p = self.params
        events = [e for e in ctx.event_store().find(p.app_name, event_names=[p.event_name],
                                                    entity_type=p.entity_type)
                  if e.target_entity_id]
        by_user = defaultdict(list)
        for e in events:
            by_user[e.entity_id].append((e.event_time, e.target_entity_id))
        transitions = []
        for _, stream in sorted(by_user.items()):
            stream.sort()
            for (_, a), (_, b) in zip(stream, stream[1:]):
                transitions.append((a, b))
        if not transitions:
            raise ValueError(f"no {p.event_name} transitions for app {p.app_name!r}; "
                             "need >=2 time-ordered views per user")
        return TrainingData(transitions=tuple(transitions))


@dataclasses.dataclass(frozen=True)
class MCParams(Params):
    top_n: int = 10


@dataclasses.dataclass(frozen=True)
class NextPageModel:
    pages: BiMap
    chain: MarkovChainModel


class MarkovChainAlgorithm(HostModelAlgorithm):
    params_class = MCParams
    query_class = Query

    def train(self, ctx, td: TrainingData) -> NextPageModel:
        pages = BiMap.string_int(pid for pair in td.transitions for pid in pair)
        counts = defaultdict(float)
        for a, b in td.transitions:
            counts[(pages[a], pages[b])] += 1.0
        chain = MarkovChain.train(
            n_states=len(pages),
            transitions=[(i, j, c) for (i, j), c in sorted(counts.items())],
            top_n=self.params.top_n, device=ctx.device)
        return NextPageModel(pages=pages, chain=chain)

    def predict(self, model: NextPageModel, query: Query) -> PredictedResult:
        try:
            state = model.pages[query.page]
        except KeyError:
            return PredictedResult(pages=())
        inv = model.pages.inverse
        return PredictedResult(pages=tuple(
            PageScore(page=inv[j], prob=p) for j, p in model.chain.predict(state)[: query.num]))


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=PageViewDataSource,
        preparator_class_map=IdentityPreparator,
        algorithm_class_map={"markov": MarkovChainAlgorithm},
        serving_class_map=FirstServing,
    )
