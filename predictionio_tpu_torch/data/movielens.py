"""MovieLens-format ratings loading + deterministic reconstruction (a
copy of the JAX package's ``data/movielens.py``, which is NumPy only:
the same seed gives the same arrays in both packages).

Quality-parity support (BASELINE.md north star: "matching MAP@10").
The reference's quickstart downloads MovieLens-100k at test time
(reference: tests/pio_tests/scenarios/quickstart_test.py) — this
environment has no network egress, so quality evaluation runs on

1. the real sample dataset the reference bundles in-tree
   (reference: examples/experimental/data/movielens.txt, the Apache
   Spark `sample_movielens_data.txt` in `user::item::rating` format),
   vendored under ``examples/data/``; and
2. a deterministic reconstruction of MovieLens-100k's published
   marginals (943 users x 1682 items x 100,000 ratings, 1-5 stars,
   >=20 ratings/user) over a known low-rank latent ground truth, so
   ALS quality is measurable at the real dataset's scale and skew.

Both produce string-id rating triples in the shape the recommendation
template's DataSource emits, so they drop straight into the template
components or the raw ops.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ML100K_USERS = 943
ML100K_ITEMS = 1682
ML100K_RATINGS = 100_000


@dataclasses.dataclass(frozen=True)
class RatingsDataset:
    """Dense-index rating triples plus the id vocabularies."""

    users: np.ndarray      # int32 (nnz,)
    items: np.ndarray      # int32 (nnz,)
    ratings: np.ndarray    # float32 (nnz,)
    num_users: int
    num_items: int

    @property
    def nnz(self) -> int:
        return len(self.users)

    def user_ids(self) -> np.ndarray:
        """String entity ids ("u1"...) as the event-store path would see."""
        return np.asarray([f"u{int(u)}" for u in self.users], dtype=object)

    def item_ids(self) -> np.ndarray:
        return np.asarray([f"i{int(i)}" for i in self.items], dtype=object)


def load_ratings_file(path: str) -> RatingsDataset:
    """Parse `user::item::rating` (Spark sample format) or the tab-separated
    MovieLens-100k `u.data` format (`user\titem\trating\ttimestamp`).

    Lines starting with ``#`` are treated as comments (provenance headers
    on vendored copies).
    """
    users, items, vals = [], [], []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("::") if "::" in line else line.split()
            users.append(int(parts[0]))
            items.append(int(parts[1]))
            vals.append(float(parts[2]))
    u = np.asarray(users, dtype=np.int32)
    i = np.asarray(items, dtype=np.int32)
    # ids may be 1-based (ML-100k) or 0-based (Spark sample); densify
    u_uniq, u_ix = np.unique(u, return_inverse=True)
    i_uniq, i_ix = np.unique(i, return_inverse=True)
    return RatingsDataset(
        users=u_ix.astype(np.int32),
        items=i_ix.astype(np.int32),
        ratings=np.asarray(vals, dtype=np.float32),
        num_users=len(u_uniq),
        num_items=len(i_uniq),
    )


def synthesize_ml100k(
    seed: int = 3,
    num_users: int = ML100K_USERS,
    num_items: int = ML100K_ITEMS,
    num_ratings: int = ML100K_RATINGS,
    latent_rank: int = 12,
    noise: float = 0.6,
    selection_gamma: float = 1.0,
) -> RatingsDataset:
    """Deterministic MovieLens-100k-statistics reconstruction.

    Matches the real dataset's marginals — 943x1682, 100k ratings, every
    user >=20 ratings, heavy item-popularity skew, 1-5 integer stars with
    mean ~3.53 — over a *known* latent model: ratings are
    ``clip(round(mu + b_u + b_i + p_u.q_i + eps), 1, 5)`` with rank-12
    gaussian factors. Because the ground truth is genuinely low-rank,
    measured MAP@10 reflects how well a factorizer recovers structure
    (the quality axis of the north-star gate) rather than fitting noise.

    ``selection_gamma`` couples WHICH items a user rates to the same
    latent preference that drives the rating value (selection keys are
    ``log_pop + gamma * (b_i + p_u.q_i) + gumbel``). Real-world rating
    data has exactly this coupling — people watch movies they expect to
    like — and without it (``selection_gamma=0``, the round-2 generator)
    item selection is user-independent, making ``popularity x
    like-rate`` the information-theoretic optimum ranker: no
    personalized top-N model *can* beat the popularity baseline, so the
    benchmark could not measure personalization at all (measured: best
    implicit-ALS MAP@10 0.126 vs popularity 0.132, converging from
    below as rank -> 1). With the coupling, implicit ALS has real
    signal to find (it beats popularity; bench key ``map10_implicit``)
    while the marginals above still hold — the pre-round/clip rating
    mean is re-centered on 3.53 after the selection bias shifts it
    (rounding and clipping then move the realized mean a few
    hundredths, as in the round-2 generator).

    Sensitivity (round-4 sweep, implicit rank 10/alpha 5/lam 0.1 vs
    popularity, 5-fold MAP@10, this generator's defaults otherwise)::

        gamma            map10_implicit  map10_popularity  ratio
        0.00 (r2 gen.)   0.1114          0.1331            0.84
        0.25             0.1188          0.1168            1.02
        0.50             0.1329          0.1017            1.31
        0.75             0.1550          0.0901            1.72
        1.00 (default)   0.1706          0.0825            2.07

    The win crosses over at gamma ~0.25 and grows monotonically — the
    gate does not hinge on the specific default, only on SOME
    preference-selection coupling existing. And the coupling is not a
    modeling choice smuggled into the benchmark: on the vendored REAL
    Spark sample dataset (examples/data/sample_movielens.txt, 30x100,
    1.5k ratings — no generator involved) implicit ALS beats popularity
    on every one of 5 folds, MAP@10 mean 0.0989 vs 0.0435 (bench keys
    ``map10_implicit_real``/``map10_popularity_real``; wide error bars
    at that size, reported honestly).
    """
    # degrees live in [20, num_items - 1]; the rescale/adjust below can
    # only terminate when num_ratings is achievable inside that box
    if not 20 * num_users <= num_ratings <= num_users * (num_items - 1):
        raise ValueError(
            f"num_ratings={num_ratings} outside the feasible range "
            f"[{20 * num_users}, {num_users * (num_items - 1)}] for "
            f"{num_users} users x {num_items} items (>=20 ratings/user)"
        )
    rng = np.random.default_rng(seed)

    # --- per-user degree: lognormal, clipped to [20, ~740], summing to nnz
    deg = np.exp(rng.normal(4.2, 0.9, size=num_users))
    deg = np.clip(deg, 20, num_items // 2 - 1)
    deg = np.maximum(20, np.round(deg * num_ratings / deg.sum())).astype(np.int64)
    deg = np.minimum(deg, num_items - 1)
    # trim/grow to hit num_ratings exactly, never dropping below 20
    diff = int(deg.sum()) - num_ratings
    order = np.argsort(-deg)
    j = 0
    while diff != 0:
        u = order[j % num_users]
        if diff > 0 and deg[u] > 20:
            deg[u] -= 1
            diff -= 1
        elif diff < 0 and deg[u] < num_items - 1:
            deg[u] += 1
            diff += 1
        j += 1

    # --- item popularity: zipf-like skew as in the real dataset
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.9
    pop = pop[rng.permutation(num_items)]
    log_pop = np.log(pop)

    # --- latent ground truth
    scale = 1.0 / np.sqrt(latent_rank)
    P = rng.normal(0.0, scale, size=(num_users, latent_rank))
    Q = rng.normal(0.0, 1.0, size=(num_items, latent_rank))
    b_u = rng.normal(0.0, 0.35, size=num_users)
    b_i = rng.normal(0.0, 0.5, size=num_items)
    mu = 3.53

    # --- per-user distinct item draws: Gumbel top-k on popularity plus
    # (selection_gamma-weighted) latent affinity — see docstring
    gumbel = rng.gumbel(size=(num_users, num_items))
    keys = log_pop[None, :] + gumbel
    if selection_gamma:
        keys = keys + selection_gamma * (b_i[None, :] + P @ Q.T)
    ranked = np.argsort(-keys, axis=1)

    users = np.repeat(np.arange(num_users, dtype=np.int32), deg)
    items = np.concatenate(
        [ranked[u, : deg[u]] for u in range(num_users)]
    ).astype(np.int32)

    raw = (
        mu
        + b_u[users]
        + b_i[items]
        + np.einsum("nk,nk->n", P[users], Q[items])
        + rng.normal(0.0, noise, size=len(users))
    )
    # selection bias (liked items over-selected) shifts the mean up;
    # re-center the continuous scores (round/clip still move the
    # realized mean slightly — see docstring)
    raw = raw - (raw.mean() - mu)
    vals = np.clip(np.round(raw), 1.0, 5.0).astype(np.float32)

    return RatingsDataset(
        users=users,
        items=items,
        ratings=vals,
        num_users=num_users,
        num_items=num_items,
    )
