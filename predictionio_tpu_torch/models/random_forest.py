"""Random forest classifier: host CART growth, batched vote walk on the
device (port of the JAX package's ``models/random_forest.py``).

Tree GROWTH is data-dependent control flow (greedy splits over changing
partitions), so it runs as vectorized NumPy on the host, copied from the
JAX package line for line: exact greedy Gini splits, bootstrap rows,
``sqrt``-feature subsampling, and the same ``rng`` draw order (a tree's
bootstrap, then its features node by node), so a seed grows the same
node tables in both packages. INFERENCE runs on the device: every tree
is flattened into dense (feature, threshold, left, right, leaf_class)
tables padded to the forest's node count, and :func:`_forest_votes`
walks all B rows down all T trees in lockstep, ``max_depth + 1`` rounds
of batched gathers (leaves loop to themselves), then counts one-hot
votes (B, C).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.utils.device import as_device_tensor, resolve_device


@dataclasses.dataclass
class ForestModel:
    """Flattened forest: (T, N) node arrays on the host; ``feature < 0``
    marks a leaf whose children loop to itself (so fixed-depth walks are
    exact)."""

    feature: np.ndarray    # int32 (T, N) split feature, -1 for leaves
    threshold: np.ndarray  # float32 (T, N) split threshold (go left if <=)
    left: np.ndarray       # int32 (T, N)
    right: np.ndarray      # int32 (T, N)
    leaf_class: np.ndarray  # int32 (T, N) majority class at the node
    max_depth: int
    num_classes: int

    @property
    def num_trees(self) -> int:
        return int(self.feature.shape[0])


def _gini_best_split(X, y, num_classes, feat_ids, min_leaf):
    """Exact best (feature, threshold) by Gini over the candidate
    features; vectorized per feature via sorted cumulative class
    counts. Only boundaries leaving >= min_leaf rows on BOTH sides are
    candidates. Returns (gain, feature, threshold) with gain <= 0 when
    no split helps."""
    n = len(y)
    counts = np.bincount(y, minlength=num_classes).astype(np.float64)  # pio: lint-ignore[dtype-discipline]: exact Gini split search on host — f32 cumsums flip ties; jitted predict stays f32
    gini_parent = 1.0 - np.sum((counts / n) ** 2)
    best = (0.0, -1, 0.0)
    for f in feat_ids:
        order = np.argsort(X[:, f], kind="stable")
        xs = X[order, f]
        ys = y[order]
        # cumulative class counts left of each boundary
        onehot = np.zeros((n, num_classes), dtype=np.float64)  # pio: lint-ignore[dtype-discipline]: same exact host-side Gini arithmetic as above
        onehot[np.arange(n), ys] = 1.0
        cum = np.cumsum(onehot, axis=0)
        # boundaries between distinct adjacent values that leave at
        # least min_leaf rows per child
        valid = np.nonzero(xs[:-1] < xs[1:])[0]
        valid = valid[(valid + 1 >= min_leaf) & (n - valid - 1 >= min_leaf)]
        if len(valid) == 0:
            continue
        nl = (valid + 1).astype(np.float64)  # pio: lint-ignore[dtype-discipline]: same exact host-side Gini arithmetic as above
        nr = n - nl
        cl = cum[valid]
        cr = counts[None, :] - cl
        gini_l = 1.0 - np.sum((cl / nl[:, None]) ** 2, axis=1)
        gini_r = 1.0 - np.sum((cr / nr[:, None]) ** 2, axis=1)
        gain = gini_parent - (nl * gini_l + nr * gini_r) / n
        j = int(np.argmax(gain))
        if gain[j] > best[0] + 1e-12:
            best = (float(gain[j]),
                    int(f),
                    float((xs[valid[j]] + xs[valid[j] + 1]) / 2.0))
    return best


def _grow_tree(X, y, num_classes, max_depth, min_leaf, n_sub_feats, rng):
    """Greedy CART; returns parallel node lists."""
    feature, threshold, left, right, leaf_class = [], [], [], [], []

    def add_node():
        feature.append(-1)
        threshold.append(0.0)
        left.append(0)
        right.append(0)
        leaf_class.append(0)
        return len(feature) - 1

    def build(rows, depth):
        i = add_node()
        ysub = y[rows]
        leaf_class[i] = int(np.bincount(ysub, minlength=num_classes).argmax())
        left[i] = right[i] = i          # leaf: self-loop
        if depth >= max_depth or len(rows) < 2 * min_leaf or \
                len(np.unique(ysub)) == 1:
            return i
        feats = rng.choice(X.shape[1], size=n_sub_feats, replace=False)
        gain, f, thr = _gini_best_split(X[rows], ysub, num_classes, feats,
                                        min_leaf)
        if f < 0:
            return i
        go_left = X[rows, f] <= thr
        if go_left.all() or not go_left.any():
            return i
        feature[i] = f
        threshold[i] = thr
        left[i] = build(rows[go_left], depth + 1)
        right[i] = build(rows[~go_left], depth + 1)
        return i

    build(np.arange(len(y)), 0)
    return feature, threshold, left, right, leaf_class


def train_forest(
    features: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    num_trees: int = 10,
    max_depth: int = 5,
    min_leaf: int = 1,
    feature_subset: str = "sqrt",
    seed: int = 0,
) -> ForestModel:
    """Bootstrap-aggregated CART forest (RandomForestAlgorithm.scala
    hyperparameter parity: numTrees/maxDepth; featureSubsetStrategy
    "sqrt"/"all"; impurity fixed to gini as in the variant)."""
    X = np.asarray(features, dtype=np.float32)
    y = np.asarray(labels, dtype=np.int64)
    if X.ndim != 2 or len(X) != len(y):
        raise ValueError(f"bad training shapes {X.shape} / {y.shape}")
    if feature_subset not in ("sqrt", "all"):
        raise ValueError(f"feature_subset must be 'sqrt' or 'all', "
                         f"got {feature_subset!r}")
    n_feats = X.shape[1]
    n_sub = (n_feats if feature_subset == "all"
             else max(1, int(np.sqrt(n_feats) + 0.5)))
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(num_trees):
        boot = rng.integers(0, len(y), size=len(y))
        trees.append(_grow_tree(X[boot], y[boot], num_classes, max_depth,
                                min_leaf, n_sub, rng))
    n_nodes = max(len(t[0]) for t in trees)

    def pad(lists, dtype, fill):
        out = np.full((num_trees, n_nodes), fill, dtype=dtype)
        for t, lst in enumerate(lists):
            out[t, :len(lst)] = lst
        return out

    return ForestModel(
        feature=pad([t[0] for t in trees], np.int32, -1),
        threshold=pad([t[1] for t in trees], np.float32, 0.0),
        left=pad([t[2] for t in trees], np.int32, 0),
        right=pad([t[3] for t in trees], np.int32, 0),
        leaf_class=pad([t[4] for t in trees], np.int32, 0),
        max_depth=max_depth,
        num_classes=num_classes,
    )


def _forest_votes(feature: torch.Tensor, threshold: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor, leaf_class: torch.Tensor, X: torch.Tensor,
                  max_depth: int, num_classes: int) -> torch.Tensor:
    """(B, C) f32 votes of the (T, N) node tables (int64 indices, f32
    thresholds) for the (B, F) rows ``X``: every tree walks every row in
    one gather a level."""
    T = feature.shape[0]
    B = X.shape[0]
    rows = torch.arange(B, device=X.device)[None, :].expand(T, B)
    idx = torch.zeros((T, B), dtype=torch.int64, device=X.device)
    for _ in range(max_depth + 1):
        f = feature.gather(1, idx)                               # (T, B)
        x = X[rows, f.clamp_min(0)]
        nxt = torch.where(x <= threshold.gather(1, idx), left.gather(1, idx),
                          right.gather(1, idx))
        idx = torch.where(f < 0, idx, nxt)                       # leaves loop
    preds = leaf_class.gather(1, idx)                            # (T, B)
    votes = torch.zeros((B, num_classes), dtype=torch.float32, device=X.device)
    return votes.scatter_add_(1, preds.T, torch.ones((B, T), device=X.device))


def device_tables(model: ForestModel, device=None) -> tuple[torch.Tensor, ...]:
    """The five node tables on ``device`` (default ``cuda``), as
    :func:`_forest_votes` takes them."""
    dev = resolve_device(device)
    as_t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dt)
    return (as_t(model.feature, torch.int64), as_t(model.threshold, torch.float32),
            as_t(model.left, torch.int64), as_t(model.right, torch.int64),
            as_t(model.leaf_class, torch.int64))


def predict_forest(model: ForestModel, features, device=None, tables=None) -> np.ndarray:
    """(B, C) vote counts for a batch of query feature vectors, walked on
    ``device`` (a tensor's own device when None, else the card). With
    ``tables``, the model's node tables already on a device (what
    :func:`device_tables` returns), the walk runs there on them and
    uploads nothing but the features."""
    if tables is not None:
        device = tables[0].device
    X = as_device_tensor(features, torch.float32, device)
    X = X.reshape(1, -1) if X.dim() == 1 else X
    if tables is None:
        tables = device_tables(model, X.device)
    return _forest_votes(*tables, X, model.max_depth, model.num_classes).cpu().numpy()


def params_from_jax(feature: np.ndarray, threshold: np.ndarray, left: np.ndarray,
                    right: np.ndarray, leaf_class: np.ndarray, max_depth: int,
                    num_classes: int) -> ForestModel:
    """A JAX-grown forest from its five node tables."""
    return ForestModel(
        feature=np.array(feature, dtype=np.int32), threshold=np.array(threshold, dtype=np.float32),
        left=np.array(left, dtype=np.int32), right=np.array(right, dtype=np.int32),
        leaf_class=np.array(leaf_class, dtype=np.int32), max_depth=int(max_depth),
        num_classes=int(num_classes))
