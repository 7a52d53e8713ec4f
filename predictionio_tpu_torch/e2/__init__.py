"""e2 — reusable engine-building library (port of the JAX package's
``e2``): small, engine-agnostic building blocks (categorical Naive
Bayes, Markov chain, binary vectorizer, cross-validation splitter), with
the counts and the transition build on the device in torch, and the
quality-parity harness (``e2/quality.py``).
"""

from predictionio_tpu_torch.e2.engine import (
    BinaryVectorizer,
    CategoricalNaiveBayes,
    CategoricalNaiveBayesModel,
    LabeledPoint,
    MarkovChain,
    MarkovChainModel,
)
from predictionio_tpu_torch.e2.evaluation import cross_validation_split

__all__ = [
    "BinaryVectorizer",
    "CategoricalNaiveBayes",
    "CategoricalNaiveBayesModel",
    "LabeledPoint",
    "MarkovChain",
    "MarkovChainModel",
    "cross_validation_split",
]
