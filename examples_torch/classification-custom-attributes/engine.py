"""Classification template, custom-attributes variant.

Port of the JAX package's ``examples/classification-custom-attributes``,
itself the reference's custom-attributes variant (reference:
examples/scala-parallel-classification/custom-attributes/): users carry
CATEGORICAL string attributes — ``gender`` ("Male"/"Female") and
``education`` ("No School"/"High School"/"College") — plus numeric
``age``, labeled by ``plan``. The DataSource maps the categorical
values to numerics with fixed maps carried through training
(DataSource.scala:46-75), queries arrive as
``{"gender": "Female", "age": 30, "education": "College"}``
(Engine.scala:23-28), and the algorithm is a random forest
(RandomForestAlgorithm.scala:43-56 — MLlib RandomForest.trainClassifier;
here the port's ``models/random_forest``: host CART growth, the same
node tables as the JAX package's for a seed, and a batched vote walk on
the device).

The model keeps the forest's node tables on the context's device
(``random_forest.device_tables``) beside the host tables, so a query
uploads only its three features; the port's persistence puts the
device tables back on the deploy's device.

Only users with ALL FOUR properties train (the reference's
``required = Some(List("plan","gender","age","education"))``,
DataSource.scala:52 — incomplete users are silently skipped, not
errors). An unknown categorical value in a QUERY is a client error and
returns a clear ValueError, where the reference would throw a
NoSuchElementException from the raw map lookup.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    FirstServing,
    HostModelAlgorithm,
    IdentityPreparator,
    Params,
    SanityCheck,
)
from predictionio_tpu_torch.models.random_forest import (
    ForestModel,
    device_tables,
    predict_forest,
    train_forest,
)
from predictionio_tpu_torch.utils.bimap import BiMap

GENDERS = {"Male": 0.0, "Female": 1.0}
EDUCATIONS = {"No School": 0.0, "High School": 1.0, "College": 2.0}


@dataclasses.dataclass(frozen=True)
class Query:
    """Parity: custom-attributes Engine.scala:23-28."""

    gender: str
    age: float
    education: str


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: str
    scores: dict


@dataclasses.dataclass(frozen=True)
class CustomAttrTrainingData(SanityCheck):
    features: np.ndarray          # (N, 3) [gender, age, education]
    labels: np.ndarray            # (N,) int
    label_map: BiMap

    def sanity_check(self) -> None:
        if len(self.features) == 0:
            raise ValueError("no users with plan/gender/age/education properties; "
                             "ingest $set events first")


@dataclasses.dataclass(frozen=True)
class CustomAttrDataSourceParams(Params):
    app_name: str = ""
    entity_type: str = "user"


class CustomAttrDataSource(DataSource):
    """Featurizes gender/age/education with the fixed categorical maps
    (DataSource.scala:46-75); only complete users train."""

    params_class = CustomAttrDataSourceParams

    def read_training(self, ctx) -> CustomAttrTrainingData:
        p = self.params
        props = ctx.event_store().aggregate_properties(p.app_name, p.entity_type)
        feats, labels = [], []
        for _, pm in props.items():
            plan = pm.get_opt("plan")
            gender = pm.get_opt("gender")
            age = pm.get_opt("age")
            education = pm.get_opt("education")
            if None in (plan, gender, age, education):
                continue          # required-properties filter
            if gender not in GENDERS or education not in EDUCATIONS:
                continue          # unmapped categorical: skip like missing
            feats.append([GENDERS[gender], float(age), EDUCATIONS[education]])
            labels.append(str(plan))
        label_map = BiMap.string_int(labels)
        return CustomAttrTrainingData(
            features=np.asarray(feats, dtype=np.float32).reshape(-1, 3),
            labels=np.asarray([label_map[lab] for lab in labels], dtype=np.int64),
            label_map=label_map)


@dataclasses.dataclass(frozen=True)
class RandomForestParams(Params):
    """Parity: RandomForestAlgorithm.scala:33-41 (numTrees/maxDepth;
    featureSubsetStrategy; impurity fixed to gini)."""

    num_trees: int = 10
    max_depth: int = 5
    feature_subset: str = "all"   # 3 features: use them all per split
    seed: int = 0


@dataclasses.dataclass
class RFModel:
    forest: ForestModel           # the host node tables
    label_map: BiMap
    #: the same five node tables on the model's device, walked per query
    tables: tuple = ()


class RandomForestAlgorithm(HostModelAlgorithm):
    """models/random_forest in the DASE slot MLlib RandomForest held."""

    params_class = RandomForestParams
    query_class = Query

    def train(self, ctx, pd: CustomAttrTrainingData) -> RFModel:
        p = self.params
        forest = train_forest(pd.features, pd.labels, num_classes=len(pd.label_map),
                              num_trees=p.num_trees, max_depth=p.max_depth,
                              feature_subset=p.feature_subset, seed=p.seed)
        return RFModel(forest=forest, label_map=pd.label_map,
                       tables=device_tables(forest, ctx.device))

    def _featurize(self, query: Query) -> np.ndarray:
        if query.gender not in GENDERS:
            raise ValueError(f"unknown gender {query.gender!r}; expected one of "
                             f"{sorted(GENDERS)}")
        if query.education not in EDUCATIONS:
            raise ValueError(f"unknown education {query.education!r}; expected one of "
                             f"{sorted(EDUCATIONS)}")
        return np.asarray([[GENDERS[query.gender], float(query.age),
                            EDUCATIONS[query.education]]], dtype=np.float32)

    def predict(self, model: RFModel, query: Query) -> PredictedResult:
        votes = predict_forest(model.forest, self._featurize(query), tables=model.tables)[0]
        inv = model.label_map.inverse
        scores = {inv[i]: float(v) / model.forest.num_trees for i, v in enumerate(votes)}
        return PredictedResult(label=inv[int(votes.argmax())], scores=scores)


def engine_factory() -> Engine:
    return Engine(
        data_source_class_map=CustomAttrDataSource,
        preparator_class_map=IdentityPreparator,
        algorithm_class_map={"randomforest": RandomForestAlgorithm},
        serving_class_map=FirstServing,
    )
